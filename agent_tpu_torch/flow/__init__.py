"""Workflow DAG engine + content-addressed result cache.

Two first-class subsystems grown out of ideas the repo already believed in:

- ``flow.dag`` promotes the controller's two-party dep-gating
  (``__collect_partials__``, which powered MPMD summarize and the disagg
  prefill->decode handoff) to arbitrary fan-out/fan-in workflow graphs
  submitted as ONE unit (``POST /v1/workflows``), following the
  dataflow-graph staging model of tf.data (arxiv 2101.12127).
- ``flow.result_cache`` promotes the serving bucketer's byte-bucket key and
  the serving prefix cache to a general content-addressed result cache keyed
  ``stable_hash(op, canonical_payload, model_version)`` — at millions of
  users duplicate work dominates, and the same cache serves both planes
  (batch shards and ``/v1/infer`` requests).

The controller owns the runtime wiring (journal replay, trace trees, usage
billing, partition placement); these modules stay pure so they can be
property-tested in isolation.
"""

from agent_tpu_torch.flow.dag import (  # noqa: F401
    DagError,
    PlannedJob,
    StageSpec,
    WorkflowSpec,
    critical_path_lengths,
    expand_workflow,
    graph_doc,
    parse_workflow,
    toposort_stages,
)
from agent_tpu_torch.flow.result_cache import ResultCache  # noqa: F401
