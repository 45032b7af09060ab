"""The block gather S2 (``gather_blocks``) and its measuring entry point.

``gather_blocks_ref``, the plain version that the CPU runs and the card's
kernel is held against, is compared here with the JAX repo's Pallas kernel
``_multi_row_kernel`` of ``scripts/profile_exact_ceiling.py`` run in
interpret mode (``pl.pallas_call(..., interpret=True)`` runs on this CPU;
the script is imported, not edited), and with the numpy definition
``out[k*r:(k+1)*r] = table[ids[k]*r:(ids[k]+1)*r]``. Also the wrapper's
contract, and ``python -m heat_tpu_torch.profile_exact_ceiling`` at a toy
size on the CPU. The kernel itself is held against the plain version in the
``cuda`` tests of tests/test_torch_kernels.py.
"""

import functools
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from heat_tpu_torch import profile_exact_ceiling as pec
from heat_tpu_torch.ops.cuda import gather

ROOT = Path(__file__).resolve().parents[1]


def _numpy_blocks(table, ids, r):
    out = np.empty((len(ids) * r, table.shape[1]), table.dtype)
    for k, i in enumerate(ids):
        out[k * r : (k + 1) * r] = table[i * r : (i + 1) * r]
    return out


def _pallas_gather_blocks(table, ids, r):
    """The JAX script's pallas_call around its kernel body, as
    ``pallas_part`` builds it (one 1,024-id tile per grid step), in
    interpret mode."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    spec = importlib.util.spec_from_file_location(
        "jax_profile_exact_ceiling", ROOT / "scripts" / "profile_exact_ceiling.py"
    )
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    tile, d = 1024, table.shape[1]
    assert len(ids) % tile == 0
    kern = functools.partial(script._multi_row_kernel, r=r, tile=tile)
    return np.asarray(pl.pallas_call(
        kern,
        grid=(len(ids) // tile,),
        in_specs=[
            pl.BlockSpec((tile,), lambda i: (i,), memory_space=pltpu.SMEM),
            pl.BlockSpec(memory_space=pltpu.HBM),
        ],
        out_specs=pl.BlockSpec((tile * r, d), lambda i: (i, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((len(ids) * r, d), jnp.float32),
        scratch_shapes=[pltpu.SemaphoreType.DMA((script.WINDOW,))],
        interpret=True,
    )(jnp.asarray(ids), jnp.asarray(table)))


@pytest.mark.parametrize("r", [1, 2, 4, 16])
def test_gather_blocks_ref_matches_the_pallas_kernel(r):
    rng = np.random.default_rng(r)
    n = 48 * r
    table = rng.normal(size=(n, 128)).astype(np.float32)
    ids = rng.integers(0, n // r, 2048).astype(np.int32)
    want = _pallas_gather_blocks(table, ids, r)
    got = gather.gather_blocks_ref(torch.from_numpy(table), torch.from_numpy(ids), r)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want, _numpy_blocks(table, ids, r))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r,d", [(1, 16), (3, 10), (8, 33)])
def test_gather_blocks_on_the_cpu_is_the_numpy_definition(dtype, r, d):
    """Any width and r, both types; the wrapper runs the plain version on
    CPU tensors and launches nothing."""
    rng = np.random.default_rng(7)
    n = 20 * r
    table = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)).to(dtype)
    ids = rng.integers(0, n // r, 50).astype(np.int32)
    before = dict(gather.LAUNCHES)
    got = gather.gather_blocks(table, torch.from_numpy(ids), r)
    assert gather.LAUNCHES == before
    assert got.dtype == dtype and got.shape == (50 * r, d)
    want = _numpy_blocks(table.float().numpy(), ids, r)
    np.testing.assert_array_equal(got.float().numpy(), want)
    # r = 1 is the row gather.
    if r == 1:
        assert torch.equal(got, gather.gather_rows(table, torch.from_numpy(ids)))
    assert gather.gather_blocks(table, torch.zeros(0, dtype=torch.int32), r).shape == (0, d)


def test_gather_blocks_rejects_what_the_kernel_does_not_take():
    table = torch.zeros(12, 8)
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of r"):
        gather.gather_blocks(table, ids, 5)
    with pytest.raises(ValueError, match="multiple of r"):
        gather.gather_blocks(table, ids, 0)
    with pytest.raises(ValueError, match="f32 or bf16"):
        gather.gather_blocks(table.double(), ids, 4)
    with pytest.raises(ValueError, match="int32"):
        gather.gather_blocks(table, ids.long(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_blocks(torch.zeros(8, 12).T, ids, 4)
    with pytest.raises(ValueError, match="contiguous"):
        gather.gather_blocks(table, torch.zeros(4, 2, dtype=torch.int32)[:, 0], 4)
    with pytest.raises(ValueError, match="1-D"):
        gather.gather_blocks(table, ids.reshape(2, 2), 4)
    # A block id outside [0, N / r) reads zeros, on the CPU as the kernel
    # writes them (gather.cu's contract).
    table = torch.arange(96, dtype=torch.float32).reshape(12, 8)
    got = gather.gather_blocks(table, torch.tensor([3, 1, -1], dtype=torch.int32), 4)
    assert not got[:4].any() and not got[8:].any()
    assert torch.equal(got[4:8], table[4:8])


TOY = ["--device", "cpu", "--iters", "2", "--items", "500", "--users", "300",
       "--his", "8", "--batch", "64", "--block-rows", "256"]


def test_profile_exact_ceiling_prints_one_json_line(capsys):
    pec.main(TOY)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    record = json.loads(lines[0])
    assert record["metric"] == "exact_gather_ceiling"
    assert record["device"] == "cpu" and record["iters"] == 2
    assert [h["width"] for h in record["history"]] == [64, 128]
    for h in record["history"]:
        assert h["rows"] == 64 * 8
        for key in ("gather_rows_ms", "gather_rows_ns_per_row",
                    "history_mean_ms", "history_mean_ns_per_row"):
            assert h[key] > 0
    for part in ("blocks", "blocks_bf16"):
        assert [b["r"] for b in record[part]] == [1, 2, 4, 8, 16]
    for b in record["blocks"] + record["blocks_bf16"]:
        assert b["rows"] == 256 and b["blocks"] == 256 // b["r"]
        assert b["ns_per_block"] == pytest.approx(b["ns_per_row"] * b["r"])
        for key in ("gather_blocks_ms", "gather_rows_ms", "index_select_ms"):
            assert b[key] > 0


def test_profile_exact_ceiling_defaults_are_the_scripts_shapes():
    assert (pec.ITEMS, pec.HIS, pec.BATCH) == (91_599, 100, 8192)
    assert pec.BLOCK_ROWS == 65_536 and pec.BLOCK_WIDTH == 128
    assert pec.BLOCK_R == (1, 2, 4, 8, 16)
    assert (pec.ITEMS // 16 * 16 + 16) == 91_600


def test_profile_exact_ceiling_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        pec.run(["--iters", "1"])
