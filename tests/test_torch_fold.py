"""K8, the plane-row fold: the port's plain version, its CUDA wrapper on
a CPU tensor and its numpy reference against the JAX Pallas kernel of
tools/packed_probe.py run in interpret mode, on the same seeded tiles.
Exact (tolerance 0), the full 32-bit digest.

``make_fold`` is local to the tool's ``main()``, which returns before it
off a TPU, so it cannot be imported: this file holds a copy with
``interpret=True`` added to the pallas_call, and
test_the_copy_equals_the_tool_s_source keeps the copy from drifting."""
import functools
import inspect
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from libflagstats_tpu.ops import bitslice as JB
from libflagstats_tpu.ops.pallas_kernels import LANE, SUB
from libflagstats_tpu_torch.ops import kernels as K
from libflagstats_tpu_torch.ops import probe_kernels as P

TOOL = Path(__file__).resolve().parent.parent / "tools" / "packed_probe.py"
nblk = 8
NEEDED = sorted(JB.NEEDED_ROWS)
#: the tool's three cases: name, tile rows, rows folded
CASES = {"full32": (32, range(32)), "sub24": (32, NEEDED), "pack24": (24, range(24))}


def make_fold(nrows, rows):
    def kernel(x_ref, out_ref):
        step = pl.program_id(0)

        @pl.when(step == 0)
        def _init():
            out_ref[...] = jnp.zeros_like(out_ref)

        acc = None
        for g in range(nblk):
            for k in rows:
                v = x_ref[g, k]
                acc = v if acc is None else acc ^ v
        out_ref[...] = out_ref[...] ^ acc

    @functools.partial(jax.jit)
    def fold(p):
        out = pl.pallas_call(
            kernel,
            grid=(p.shape[0] // nblk,),
            in_specs=[pl.BlockSpec((nblk, nrows, SUB, LANE),
                                   lambda i: (i, 0, 0, 0),
                                   memory_space=pltpu.VMEM)],
            out_specs=pl.BlockSpec((SUB, LANE), lambda i: (0, 0),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((SUB, LANE), jnp.uint32),
            interpret=True,
            )(p)
        return jax.lax.reduce(out.ravel(), jnp.uint32(0),
                              jax.lax.bitwise_xor, (0,)).astype(
                                  jnp.int32)[None]

    return fold


def test_the_copy_equals_the_tool_s_source():
    tool = textwrap.dedent("".join(TOOL.read_text().splitlines(keepends=True)[54:86]))
    copy = "".join(line for line in inspect.getsource(make_fold).splitlines(keepends=True)
                   if line.strip() != "interpret=True,")
    assert tool.startswith("def make_fold(nrows, rows):") and tool.rstrip().endswith("return fold")
    assert copy == tool


def _tiles(groups: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << 32, size=(groups, 32, SUB, LANE), dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("groups", [8, 16])
@pytest.mark.parametrize("case", list(CASES))
def test_fold_equals_pallas_interpret(case, groups):
    nrows, rows = CASES[case]
    host = _tiles(groups, seed=groups)
    if nrows == 24:
        host = np.ascontiguousarray(host[:, NEEDED])
    want = int(np.asarray(make_fold(nrows, rows)(jnp.asarray(host)))[0]) & 0xFFFFFFFF
    rows = None if len(rows) == nrows else list(rows)
    assert P.fold_xor_np(host, rows) == want
    before = dict(K.LAUNCHES)
    for t in (torch.from_numpy(host), torch.from_numpy(host.view(np.int32))):
        for got in (P.fold_xor_plain(t, rows), P.fold_xor_cuda(t, rows)):
            assert got.shape == (1,) and got.dtype == torch.int32
            assert P.digest(got) == want
    assert K.LAUNCHES == before  # the plain version is no launch


@pytest.mark.parametrize("groups", [0, 1, 7, 9])
def test_any_group_count(groups):
    """No step depth: the port folds group counts the TPU grid would cut."""
    host = _tiles(groups, seed=40 + groups)
    t = torch.from_numpy(host)
    for rows in (None, NEEDED, [31], []):
        want = P.fold_xor_np(host, rows)
        assert P.digest(P.fold_xor_plain(t, rows)) == want
        assert P.digest(P.fold_xor_cuda(t, rows)) == want
    assert P.fold_xor_np(host, []) == 0


def test_plain_version_in_chunks(monkeypatch):
    monkeypatch.setattr(P, "PLAIN_CHUNK_GROUPS", 2)
    host = _tiles(5, seed=3)
    assert P.digest(P.fold_xor_plain(torch.from_numpy(host), NEEDED)) == P.fold_xor_np(host, NEEDED)


def test_sub24_of_32_rows_equals_pack24():
    host = _tiles(3, seed=9)
    packed = torch.from_numpy(np.ascontiguousarray(host[:, NEEDED]))
    assert torch.equal(P.fold_xor_plain(torch.from_numpy(host), NEEDED), P.fold_xor_plain(packed))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    good = torch.zeros((2, 32, 8, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        P.fold_xor_cuda(torch.zeros((2, 32, 8, 128), dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="plane tiles"):
        P.fold_xor_cuda(torch.zeros((2, 20, 8, 128), dtype=torch.int32))
    with pytest.raises(ValueError, match="uint32"):
        P.fold_xor_cuda(good.to(torch.int64))
    with pytest.raises(ValueError, match=r"rows must lie in \[0, 24\)"):
        P.fold_xor_cuda(torch.zeros((2, 24, 8, 128), dtype=torch.int32), [3, 24])
    with pytest.raises(ValueError, match="rows must lie"):
        P.fold_xor_plain(good, [-1])
    with pytest.raises(TypeError):
        P.fold_xor_cuda(np.zeros((2, 32, 8, 128), np.uint32))
