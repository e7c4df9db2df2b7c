"""OpContext — the optional ``ctx`` argument every op accepts; counterpart
of ``agent_tpu.runtime.context.OpContext``. It hands ops the device runtime
and the agent's configuration (the serving ops read ``config.serve``), and
carries per-task annotations (``tags``) that ops may add timings to."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class OpContext:
    runtime: Optional[object] = None  # TorchRuntime
    tags: Dict[str, Any] = field(default_factory=dict)
    config: Optional[object] = None   # agent_tpu_torch.config.Config

    def require_runtime(self):
        """The runtime, building the process singleton if none was injected."""
        if self.runtime is None:
            from agent_tpu_torch.runtime.runtime import get_runtime

            self.runtime = get_runtime()
        return self.runtime
