"""A whole run of each cell, its look for a card skipped, at a small size on
the CPU (the kernels' plain twins): sound, it comes out correct; with the
timed path broken underneath by each fault a global BA can have, and with
the control (the reference in TF32 in the program's place), it does not.

The limits are the cells' own, set at the cells' sizes on the card. Small
maps are weakly constrained: their last LM steps gain less than float32's
rounding of the error, so on some seeds a float32 solve (the program's,
or the reference's in plain float32) drops steps that float64 keeps and
reads above the limits there. The seeds below read within them, so that
each fault's effect is what flips the verdict."""
import json

import pytest
import torch

from slambench import run as bench_run
from slambench.harness import faults, reference
from slambench.tests.small import SmallBench
from slambench.tools import readings

SOUND_SEED = {"kitti-stereo.global-ba": 1}
CELLS = sorted(SOUND_SEED)


def _run(capsys, cell, seed):
    args = bench_run.parse(["--workload", cell, "--seed", str(seed), "--seconds", "0.01",
                            "--trace", "0"])
    assert bench_run.run(args, SmallBench(), torch.device("cpu")) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(capsys, cell):
    out = _run(capsys, cell, SOUND_SEED[cell])
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert "setup_s" in out["metrics"]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_fault_makes_the_run_incorrect(capsys, monkeypatch, cell, fault):
    entry_setup = SmallBench().entry("global_ba").setup
    held = []

    def setup(*a, **k):
        st = entry_setup(*a, **k)
        ctx = faults.FAULTS[fault](st)
        ctx.__enter__()
        held.append(ctx)
        return st
    mod = SmallBench().entry("global_ba")
    monkeypatch.setattr(mod, "setup", setup)
    monkeypatch.setattr(SmallBench, "entry", lambda self, name: mod)
    try:
        out = _run(capsys, cell, SOUND_SEED[cell])
    finally:
        for ctx in held:
            ctx.__exit__(None, None, None)
    assert out["correct"] is False and out["failed"] == out["attempted"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    b = SmallBench()
    c = b.cell(cell)
    data, traffic = b.config(c["config"]), b.traffic(c["traffic"])
    st = b.entry("global_ba").setup(data, traffic, SOUND_SEED[cell], torch.device("cpu"), 0.01)
    run_checks = set(b.entry("global_ba").precision_checks(()))
    limits = {k: v for k, v in b.limits(cell)["limits"].items() if k not in run_checks}
    control = readings.control_gaps(b.entry("global_ba"), st, "tf32")
    assert any(not control[k] <= v for k, v in limits.items()), control
    plain = readings.control_gaps(b.entry("global_ba"), st, "float32")
    assert all(plain[k] <= v for k, v in limits.items()), plain


def test_control_rounds_every_product():
    ar = reference.Arith("tf32")
    a = torch.full((2, 2), 1.0 + 2 ** -12)
    assert torch.equal(ar.mm(a, torch.eye(2)), torch.ones(2, 2))
    assert torch.equal(reference.Arith("float32").mm(a, torch.eye(2)), a)


@pytest.mark.parametrize("cell", CELLS)
def test_tf32_makes_the_run_incorrect(capsys, cell):
    """The configuration states float32 with TF32 off: a run left to use
    TF32 is not correct, whatever its answers read."""
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = _run(capsys, cell, SOUND_SEED[cell])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert out["correct"] is False
    assert out["checks"]["tf32_matmul"] == {"value": 1, "limit": 0}


# device kernels of the program's global BA on an H100, as configured and
# with torch's TF32 allowed (`tools/readings.py --kernels`)
SOUND_KERNELS = [
    "(anonymous namespace)::ba_assemble_kernel((anonymous namespace)::Args)",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nt_n_tilesize128x32x8_stage3_warpsize2x2x1_ffma_aligna4_"
    "alignc4_execute_split_k_kernel__5x_cublas",
    "std::enable_if<true, void>::type internal::gemvx::kernel<int, int, float, float, float, "
    "float, true, true, true, false, 6, false, cublasGemvParamsEx<int>>",
    "void getrf_semiwarp<float, float, 3, 1, true>(int, float* const*, int, int*, int*, int)",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>, "
    "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<float>, std::array<char*, 3ul>)",
    "Memcpy DtoD (Device -> Device)"]
LOW_KERNELS = [
    "sm80_xmma_gemm_f32f32_tf32f32_f32_tn_n_tilesize32x32x64_stage3_warpsize2x2x1_tensor16x8x8_"
    "aligna4_alignc4_execute_kernel__5x_cublas",
    "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x256_32x4_nt_align1>"
    "(cutlass_80_tensorop_s1688gemm_64x256_32x4_nt_align1::Params)",
    "ampere_bf16_s16816gemm_bf16_128x128_ldg8_f2f_stages_32x5_nn",
    "void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<c10::Half>, "
    "std::array<char*, 3ul> >(int, at::native::CUDAFunctor_add<c10::Half>, std::array<char*, 3ul>)"]


def test_kernels_below_float32_are_named():
    entry = SmallBench().entry("global_ba")
    assert entry.precision_checks(SOUND_KERNELS)["low_precision_kernels"] == 0
    assert entry.precision_checks(LOW_KERNELS)["low_precision_kernels"] == len(LOW_KERNELS)
