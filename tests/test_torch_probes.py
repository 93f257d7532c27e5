"""The arithmetic probes of the port (utils/roofline.py) on the CPU: the plain
versions of K3 (`fma_peak_reference`) and K4 (`slab_dtype_reference`) against
the JAX package's probe bodies run through `pl.pallas_call(interpret=True)`
on the shapes the TPU probes use, at a few rounds; and the op counts.

The CUDA kernels are held to these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gpu_ray_tracing_tpu_torch.utils import roofline

# The benchmark scripts point jax's compilation cache at a directory of their
# own when imported; the tests keep the setting they started with.
_cache_dir = jax.config.jax_compilation_cache_dir
from benchmarks import bf16_probe, vpu_roofline  # noqa: E402

# The suite runs in several worker processes at once: one torch thread
# each keeps them from oversubscribing the CPU.
torch.set_num_threads(1)

jax.config.update("jax_compilation_cache_dir", _cache_dir)

ROUNDS = 24


def _probe_input(shape, seed):
    return np.random.default_rng(seed).uniform(0.5, 1.5, shape).astype(np.float32)


@pytest.mark.parametrize("chains", [1, 2])
@pytest.mark.parametrize("mix", ["slab", "fma"])
def test_fma_peak_reference_matches_the_jax_probe_body(mix, chains):
    """K3 on the TPU probe's (256, 128) tile, 24 rounds.  XLA:CPU contracts
    a * k + b into one fused multiply-add where the port's fma mix calls
    ops/rounding.fma, and leaves the slab mix's blends as the port writes
    them: both mixes agree to 2 ulp of the result (rtol 2.4e-7), and the
    count of operations equals the probe's own `ops_of`."""
    x = _probe_input((256, 128), 3)
    kernel, ops_of = vpu_roofline._peak_kernel_factory(ROUNDS, mix, chains)
    want = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, jnp.float32), interpret=True)(
            jnp.asarray(x)))
    got = roofline.fma_peak(torch.from_numpy(x), ROUNDS, mix, chains)
    assert got.shape == x.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2.4e-7, atol=0.0)
    assert roofline.ops_of(mix, chains, ROUNDS, x.size) == ops_of(x.shape)


def test_fma_peak_counts_and_four_chains():
    """The counts the rates are computed from: the probe's ops per bundle
    (19 and 12), the FP32 operations as written (23, none fused; 3 fused
    multiply-adds and a multiply = 7) and the instructions (23 and 4).  Four
    chains, which the TPU probe did not run, follow the same recipe: chain g
    starts from (x + 0.1 g, x / 2 + 0.25 + 0.05 g, x / 4 + 0.5)."""
    assert roofline.PROBE_OPS == {"slab": 19, "fma": 12}
    assert roofline.flops_of("slab", 4, 10, 100) == 4 * 23 * 10 * 100
    assert roofline.flops_of("fma", 2, 10, 100) == 2 * 7 * 10 * 100
    assert roofline.BUNDLE_INSTRUCTIONS == {"slab": 23, "fma": 4}
    x = torch.from_numpy(_probe_input((64,), 4))
    zero = roofline.fma_peak(x, 0, "fma", 4)
    want = sum((x + np.float32(0.1 * g)) + (x * 0.5 + 0.25 + np.float32(0.05 * g))
               + (x * 0.25 + 0.5) for g in range(4))
    np.testing.assert_allclose(zero.numpy(), want.numpy(), rtol=3e-7)
    with pytest.raises(ValueError, match="chains"):
        roofline.fma_peak(x, 4, "fma", 3)
    with pytest.raises(ValueError, match="mix"):
        roofline.fma_peak(x, 4, "mad", 2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_slab_dtype_reference_matches_the_jax_probe_body(dtype, monkeypatch):
    """K4 on the TPU probe's (32, 128) input, 24 rounds.  bf16 is exact: both
    round every operation to bf16.  In f32 XLA:CPU contracts acc + tf * tn
    into one fused multiply-add where the port (and its kernel, built without
    contraction) rounds twice: 30% of the elements differ, by 5.8e-7
    relative at most; held to 1e-6."""
    monkeypatch.setattr(bf16_probe, "ROUNDS", ROUNDS)
    x = np.linspace(0.5, 1.5, 32 * 128, dtype=np.float32).reshape(32, 128)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = np.asarray(pl.pallas_call(
        functools.partial(bf16_probe.kern, dtype=jdt),
        out_shape=jax.ShapeDtypeStruct((32, 128), jnp.float32), interpret=True)(jnp.asarray(x)))
    got = roofline.slab_dtype(torch.from_numpy(x), ROUNDS, tdt)
    assert got.dtype == torch.float32
    if dtype == "bf16":
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0.0)


def test_slab_dtype_compare_form_and_argument_checks():
    """The compare form `acc + (tf >= tn) * tn` (the one the TPU's compiler
    refused for packed bf16): tf >= tn always holds, so it accumulates tn."""
    x = torch.linspace(0.5, 1.5, 256)
    for dt in (torch.float32, torch.bfloat16):
        v, acc = x.to(dt), torch.zeros(256, dtype=dt)
        c1 = torch.tensor(1.0009765625, dtype=dt)
        for _ in range(8):
            acc = acc + torch.minimum((v - c1) * v, (v + c1) * v)
            v = v * c1
        assert torch.equal(roofline.slab_dtype(x, 8, dt, compare=True), acc.float())
    with pytest.raises(ValueError, match="dtype"):
        roofline.slab_dtype(x, 8, torch.float16)
    with pytest.raises(ValueError, match="rounds"):
        roofline.slab_dtype(x, -1)


def test_the_timed_probes_need_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible; the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="need an NVIDIA GPU"):
        roofline.measure_peak(rounds=4)
    with pytest.raises(RuntimeError, match="need an NVIDIA GPU"):
        roofline.bf16_probe(rounds=4)
