"""The swarm worker: the agent loop (``app``), the pipelined runner
(``pipeline``) and the result spool (``spool``)."""
