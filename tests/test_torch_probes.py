"""The plain versions of the two probe kernels (P1 vpu_chain, P2
slab_chain) against the TPU probes' Pallas kernels in interpret mode, on
the same inputs (the CUDA kernels against the plain versions on the card:
tests/test_torch_kernels_cuda.py).

The TPU scripts time a TPU when imported, so `make` and the shape
constants are read out of scripts/vpu_probe.py and scripts/slab_probe.py
with `ast` and run with `pl.pallas_call(..., interpret=True)`; the
scripts themselves are not imported or changed. P2's launch geometry
(`slab_probe.launch_geometry`) is checked here too, against a Python walk
of the kernel's loops.
"""

import ast
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gags_torch import probes
from gags_torch.probes import slab_probe, vpu_probe

SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"
JDTYPES = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _load_probe(name, names):
    """The top-level functions and constants `names` of scripts/<name>,
    with pallas_call in interpret mode."""
    path = SCRIPTS / name
    tree = ast.parse(path.read_text(), filename=str(path))

    def wanted(node):
        if isinstance(node, ast.FunctionDef):
            return node.name in names
        if isinstance(node, ast.Assign):
            targets = [e for t in node.targets
                       for e in (t.elts if isinstance(t, ast.Tuple) else [t])]
            return any(getattr(t, "id", None) in names for t in targets)
        return False

    module = ast.Module(body=[n for n in tree.body if wanted(n)], type_ignores=[])
    pl_interp = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                         if not k.startswith("__")})
    pl_interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns = dict(jax=jax, jnp=jnp, pl=pl_interp, pltpu=pltpu, functools=functools)
    exec(compile(module, str(path), "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def vpu():
    return _load_probe("vpu_probe.py", {"make", "R", "C"})


@pytest.fixture(scope="module")
def slab():
    return _load_probe("slab_probe.py", {"make", "chain", "P", "G", "REPS"})


def _inputs(shape, dtype, seed=0):
    """The same U[0, 1) values (numpy, seeded) as a jax and a torch array."""
    x = np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)
    return jnp.asarray(x).astype(JDTYPES[dtype]), torch.from_numpy(x).to(dtype)


def _host(a):
    """float32 numpy copy of a jax or torch array (exact for bf16)."""
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a.astype(jnp.float32))


def test_probe_shapes_match_the_scripts(vpu, slab):
    assert (vpu["R"], vpu["C"]) == (vpu_probe.R, vpu_probe.C)
    assert (slab["P"], slab["G"], slab["REPS"]) == (slab_probe.P, slab_probe.G, slab_probe.REPS)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_vpu_chain_plain_matches_pallas(vpu, dtype):
    """bf16 bit for bit; f32 within 1 ulp (the exp2 implementations differ
    in the last bit at a few hundred of the 131,072 values)."""
    xj, xt = _inputs((vpu["R"], vpu["C"]), dtype)
    want = _host(vpu["make"](JDTYPES[dtype])(xj))
    got = _host(vpu_probe.vpu_chain(xt))  # CPU tensor: the plain version
    assert np.isfinite(got).all()
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(got, want)
    else:
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
        assert ulps.max() <= 1, ulps.max()
        assert (ulps > 0).mean() < 0.01


def test_vpu_chain_plain_reps_is_repeated_application(vpu):
    """reps = 3 is three passes of the TPU kernel (bf16: bit for bit)."""
    xj, xt = _inputs((vpu["R"], vpu["C"]), torch.bfloat16, seed=1)
    run = vpu["make"](jnp.bfloat16)
    want = _host(run(run(run(xj))))
    np.testing.assert_array_equal(_host(vpu_probe.vpu_chain_plain(xt, reps=3)), want)


@pytest.mark.parametrize("slab_rows", slab_probe.SLABS, ids=lambda s: f"slab{s}")
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_slab_chain_plain_matches_pallas(slab, dtype, slab_rows):
    """All 24 applications, every slab size, bit for bit in both types."""
    xj, xt = _inputs((slab["P"], slab["G"]), dtype)
    want = _host(slab["make"](JDTYPES[dtype], slab_rows)(xj))
    got = _host(slab_probe.slab_chain(xt, slab_rows))  # CPU tensor: the plain version
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)


def test_probe_wrappers_refuse_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        vpu_probe.vpu_chain(torch.zeros(8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        slab_probe.slab_chain(torch.zeros((8, 8), device="meta"))


def test_probe_mains_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        vpu_probe.main([])
    with pytest.raises(RuntimeError, match="CUDA"):
        slab_probe.main([])


def test_probe_mains_on_cpu_print_rates(capsys, monkeypatch):
    """--device cpu times the plain versions (small stand-in shapes)."""
    monkeypatch.setattr(vpu_probe, "RATE_SHAPE", (16, 32))
    monkeypatch.setattr(vpu_probe, "RATE_REPS", 2)
    monkeypatch.setattr(slab_probe, "SLABS", (None, 256))
    before = dict(probes.launch_counts)
    r1 = vpu_probe.main(["--device", "cpu"])
    r2 = slab_probe.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert len(r1) == 4 and len(r2) == 4 and all(v > 0 for v in {**r1, **r2}.values())
    assert "Gelem/s" in out and "ps/pair-chain" in out
    assert probes.launch_counts == before  # the plain versions launch nothing


def _kernel_coverage(g, rows, cols):
    """How many times slab_chain_kernel's loops (csrc/slab_chain.cu) visit
    each element of a (rows, cols) block under launch geometry `g`."""
    seen = np.zeros(rows * cols, np.int64)
    per, step = g.elems_per_chain, g.elems_per_chain * g.threads
    threads = np.arange(g.threads)
    for b in range(g.blocks):
        r0, r1 = b * g.band_rows, min(rows, (b + 1) * g.band_rows)
        for p0 in range(r0, r1, g.pass_rows):
            begin, end = p0 * cols, min(r1, p0 + g.pass_rows) * cols
            e0 = begin + per * threads
            while (e0 < end).any():
                for lane in range(g.lanes):
                    for k in range(per):
                        e = e0 + lane * step + k
                        np.add.at(seen, e[(e0 + lane * step < end) & (e < end)], 1)
                e0 = e0 + g.lanes * step
    return seen


@pytest.mark.parametrize("shape", [(1024, 128), (37, 13), (8192, 512)], ids=str)
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("slab_rows", slab_probe.SLABS + (1, 3), ids=lambda s: f"slab{s}")
def test_slab_launch_geometry_fills_the_card(shape, bf16, slab_rows):
    """P2's launch on 132 SMs: at least min(132, possible) blocks, where a
    block takes whole rows and at least a warp of threads of two elements;
    at most `slab` rows carried at once; every element visited exactly
    once."""
    rows, cols = shape
    g = slab_probe.launch_geometry(rows, cols, slab_rows, bf16, sms=132)
    per = 2 if bf16 else 1
    possible = min(rows, -(-rows * cols // (32 * 2)))
    assert g.blocks >= min(132, possible)
    # the (dtype, lanes) pairs csrc/slab_chain.cu builds
    assert g.elems_per_chain == per and g.lanes in ((1, 2, 4) if bf16 else (2, 4))
    assert g.elems_per_thread >= 2
    assert g.threads % 32 == 0 and 32 <= g.threads <= 1024
    assert g.pass_rows <= g.band_rows and (slab_rows is None or g.pass_rows <= slab_rows)
    assert (g.blocks - 1) * g.band_rows < rows <= g.blocks * g.band_rows
    # a pass's chains fit the block's threads at once
    assert g.threads * g.lanes * per >= g.pass_rows * cols or g.threads == 1024
    seen = _kernel_coverage(g, rows, cols)
    assert seen.min() == 1 and seen.max() == 1
