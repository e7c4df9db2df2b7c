"""chip_smoke.py reads the kernels' names, from the profiler (demangled) and
from cuobjdump and ptxas (mangled), to count launches by forward variant,
to split device time into flash_attention / flash_fold / flash_t5 and to
find every TMA + wgmma instantiation in the build. Each name of every
instantiation the libraries hold must parse the same both ways, so that
split cannot drift silently. Runs on the CPU: chip_smoke imports only
numpy and torch at module level."""

import itertools

import pytest

import chip_smoke

D_HEADS = (32, 64, 128)
# (WriteLse, CarryState, RelBias) of each forward that launch_fwd
# instantiates: serving, training with lse, the ring's fold, T5.
FORWARDS = ((False, False, False), (True, False, False), (False, True, False),
            (False, False, True))
SM90_ARGS = ("CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, int const*, "
             "float*, int, int, int, int, int, float, float const*, int, float*, float*, float*")
F32_ARGS = ("float const*, float const*, float const*, int const*, float*, float*, int, int, "
            "int, int, int, float, float*, float*, float*, float const*, int")


def _bools(flags, demangled: bool) -> str:
    if demangled:
        return "".join(f", {str(f).lower()}" for f in flags)
    return "".join(f"Lb{int(f)}E" for f in flags)


def _forward(kind: str, d: int, flags, demangled: bool) -> str:
    if demangled:
        scope = "(anonymous namespace)::sm90::" if kind == "sm90" else "(anonymous namespace)::"
        args = SM90_ARGS if kind == "sm90" else F32_ARGS
        return f"void {scope}flash_fwd_{kind}<{d}{_bools(flags, True)}>({args})"
    scope = "_ZN12_GLOBAL__N_14sm9014" if kind == "sm90" else "_ZN12_GLOBAL__N_113"
    tail = "Ev14CUtensorMap_stS1_S1_S1_PKiPfiiiiifPKfiS3_S3_S3_" if kind == "sm90" \
        else "EvPKfS2_S2_PKiPfS5_iiiiifS5_S5_S5_S2_i"
    return f"{scope}flash_fwd_{kind}ILi{d}E{_bools(flags, False)}E{tail}"


def _backward(which: str, d: int, demangled: bool) -> str:
    name = f"flash_bwd_{which}_sm90"
    if demangled:
        return (f"void (anonymous namespace)::sm90::bwd::{name}<{d}>(CUtensorMap_st, "
                "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "
                "__nv_bfloat16 const*, int const*, float const*, float*, int, int, int, int, "
                "int, float)")
    return f"_ZN12_GLOBAL__N_14sm903bwd{len(name)}{name}ILi{d}EEEv14CUtensorMap_stS1_S1_S1_S1_"


def _kind(flags) -> str:
    _, carry, bias = flags
    return "flash_t5" if bias else "flash_fold" if carry else "flash_attention"


def _cases():
    for demangled, d in itertools.product((True, False), D_HEADS):
        how = "demangled" if demangled else "mangled"
        for flags in FORWARDS:
            named = dict(zip(("lse", "carry", "bias"), flags))
            readable = f"flash_fwd_sm90<{d}, " + ", ".join(
                f"{f}={str(on).lower()}" for f, on in named.items()) + ">"
            yield (f"sm90-{how}-d{d}-{''.join('1' if f else '0' for f in flags)}",
                   _forward("sm90", d, flags, demangled), ("sm90", named), readable,
                   _kind(flags))
            yield (f"f32-{how}-d{d}-{''.join('1' if f else '0' for f in flags)}",
                   _forward("f32", d, flags, demangled), ("f32", named), None, _kind(flags))
        for which in ("dq", "dkv"):
            yield (f"bwd_{which}-{how}-d{d}", _backward(which, d, demangled), None,
                   f"flash_bwd_{which}_sm90<{d}>", "flash_attention_bwd")


CASES = list(_cases())


@pytest.mark.parametrize("name, want_variant, want_sm90, want_kind",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_kernel_names_parse(name, want_variant, want_sm90, want_kind):
    assert chip_smoke.fwd_variant(name) == want_variant
    assert chip_smoke.sm90_name(name) == want_sm90
    assert chip_smoke.kernel_kind(name) == want_kind


@pytest.mark.parametrize("name", ["void at::native::elementwise_kernel<128, 4>(int)",
                                  "nvjet_hsh_128x256_64x4_1x2_h_bz_coopB_NTN",
                                  "flash_fwd_bf16<64, true>"])
def test_other_kernels_are_no_sm90_instantiation(name):
    assert chip_smoke.fwd_variant(name) is None and chip_smoke.sm90_name(name) is None


# Phase 12's decoder steps run cuBLAS's batched GEMV (one query row against
# the cached keys) and phase 11's the GEMMs: both are matmuls in the split.
@pytest.mark.parametrize("name", [
    "std::enable_if<true, void>::type internal::gemvx::kernel<int, int, float, float, "
    "float, float, false, true, true, false, 7, false, cublasGemvParamsEx<int, "
    "cublasGemvTensorStridedBatched<float const>>>",
    "nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN"])
def test_cublas_kernels_are_matmuls(name):
    assert chip_smoke.kernel_kind(name) == "matmul"


@pytest.mark.parametrize("number,name", [("11", "bert"), ("12", "bart")])
def test_the_checkpoint_phases_are_documented_and_emitted(number, name):
    """Phases 11 and 12 are in the script's phase list and each prints its
    checkpoint line and its result line."""
    import inspect

    assert f"\n{number}. {name}" in chip_smoke.__doc__
    source = inspect.getsource(chip_smoke)
    for phase in (name, f"{name}_checkpoint"):
        assert f'"phase": "{phase}"' in source, phase
    assert callable(getattr(chip_smoke, f"{name}_phase"))


def _event(key, device, count=1, us=10.0):
    from types import SimpleNamespace

    return SimpleNamespace(key=key, count=count, self_device_time_total=us,
                           device_type=SimpleNamespace(name=device))


@pytest.mark.parametrize("spins", [0, 3, chip_smoke.PROFILE_PREFIX])
def test_profile_prefix_is_left_out_of_the_call(spins):
    """The spin kernels a profiled session launches before the call are
    counted apart and never enter the call's device events."""
    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    call = [_event(_forward("sm90", 64, (False, False, False), True), "CUDA", 12),
            _event("nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN", "CUDA", 48),
            _event("Memcpy HtoD (Pinned -> Device)", "CUDA", 2)]
    averages = [_event("aten::_local_scalar_dense", "CPU"), *call]
    if spins:
        averages.insert(1, _event(spin, "CUDA", spins))
    events, traced = chip_smoke.call_events(averages)
    assert events == call and traced == spins
    assert all(chip_smoke.PREFIX_KERNEL not in e.key for e in events)
