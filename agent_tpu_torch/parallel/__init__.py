"""Parallelism over the runtime's mesh: the spec trees and the cutting of
weights by them (``shardings``), the one-process collectives
(``collectives``), ring attention over ``sp`` (``ring``) and the GPipe
encoder pipeline over ``pp`` (``pipeline``)."""
