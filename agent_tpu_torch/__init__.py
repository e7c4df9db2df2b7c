"""agent_tpu_torch — the PyTorch/CUDA port of ``agent_tpu``.

The package keeps ``agent_tpu``'s module layout and names so each module's
counterpart is easy to find, and imports nothing from it: where the port
needs a module of the JAX package, it keeps its own copy cut down to what it
uses. Importing the package initialises no CUDA state; the runtime
(``runtime.runtime.TorchRuntime``) owns the device, and the CUDA kernels
build at first use (``kernels.build``).
"""
