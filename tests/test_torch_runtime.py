"""TorchRuntime's caches: weights and forward functions are built once per
key, also under concurrent first callers, and evicting or clearing makes
the next call rebuild. Runs on a CPU runtime."""

import threading
import time

import numpy as np
import torch

from agent_tpu_torch.runtime.runtime import TorchRuntime

torch.set_num_threads(1)


def test_get_params_builds_once_under_concurrent_callers():
    rt = TorchRuntime(device="cpu")
    builds, got = [], []

    def build():
        builds.append(1)
        time.sleep(0.05)  # keep the build in flight while the others arrive
        return torch.nn.Linear(2, 2)

    threads = [threading.Thread(target=lambda: got.append(rt.get_params("m", build)))
               for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(builds) == 1 and len(got) == 8
    assert all(m is got[0] for m in got)
    assert next(got[0].parameters()).device.type == "cpu"


def test_evict_and_clear_rebuild_and_describe_lists_resident_models():
    rt = TorchRuntime(device="cpu")
    builds = []

    def build():
        builds.append(1)
        return torch.nn.Linear(2, 2)

    first = rt.get_params("a", build)
    rt.get_params("b", build)
    assert rt.get_params("a", build) is first and len(builds) == 2
    assert rt.describe()["models_resident"] == ["a", "b"]
    rt.evict_params("a")
    assert rt.describe()["models_resident"] == ["b"]
    assert rt.get_params("a", build) is not first and len(builds) == 3
    rt.clear_params()
    desc = rt.describe()
    assert desc["models_resident"] == [] and desc["platform"] == "cpu"
    assert desc["n_devices"] == 1 and rt.axis_size("tp") == 1


def test_compiled_is_build_once_and_put_batch_keeps_values():
    rt = TorchRuntime(device="cpu")
    fn = rt.compiled(("op", 4, 16), lambda: (lambda x: x + 1))
    assert rt.compiled(("op", 4, 16), lambda: None) is fn
    assert rt.cache.stats() == {"entries": 1, "hits": 1, "misses": 1}
    arr = np.arange(12, dtype=np.int32).reshape(3, 4)[:, ::2]  # not contiguous
    t = rt.put_batch(arr)
    assert t.device.type == "cpu" and t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy(), arr)
