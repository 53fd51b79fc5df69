"""Launch geometry of the flash-attention forward kernel (B1), on the CPU.

``ops/flash_attention.py::_fwd_geometry`` picks the warps per block, the
keys per K/V tile and the grid from (B, S, H, D, dtype); the kernel itself
runs only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``),
where its shared-memory layout is also checked against
``_fwd_smem_bytes``. ``_fwd_design`` picks B1's second design (the wgmma
kernel) by shape, and ``_fwd_wgmma_geometry`` is that design's geometry."""

import pytest
import torch

from superdiff_torch.ops import flash_attention as fa

@pytest.mark.parametrize("elem_size", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("S", [1, 17, 64, 256, 1000, 1024, 4096])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_geometry_covers_s_and_fits_the_card(D, S, elem_size):
    """Query tiles cover S exactly (no tile past the end) and are no taller
    than needed (one warp, or no warp's rows wholly past S), (bk, mt) is
    the instantiation the kernel is built with, the block has 1-8 warps, the
    shared memory fits in one block's 227 KB, and both grid dimensions are
    in range."""
    B, H = 16, 4
    warps, bk, mt, grid, smem = fa._fwd_geometry(B, S, H, D, elem_size)
    rows = 16 * mt * warps
    assert warps in (1, 2, 4, 8)
    assert grid == (B * H, -(-S // rows))
    assert grid[1] * rows >= S > (grid[1] - 1) * rows
    assert warps == 1 or rows <= max(S, 16 * mt)
    assert (bk, mt) == fa._FWD_TILE[(0 if elem_size == 2 else 1, D)]
    assert smem == fa._fwd_smem_bytes(D, elem_size, warps, bk, mt)
    assert 0 < smem <= fa.MAX_SMEM
    assert 1 <= grid[0] <= 2 ** 31 - 1 and 1 <= grid[1] <= 65535


@pytest.mark.parametrize("B,S,H,D,expect", [
    (16, 1024, 4, 32, (8, 32, 2, 256)), (16, 256, 4, 64, (8, 64, 1, 128)),
    (16, 64, 4, 64, (4, 64, 1, 64))], ids=["S1024_D32", "S256_D64", "S64_D64"])
def test_path_shapes_take_the_measured_geometry(B, S, H, D, expect):
    """The wide256 path shapes get the geometry that
    tools/tune_flash_fwd.py --sweep measured fastest on the H100 (PERF.md): at
    S=1024 the grid fills the 132 SMs (256 blocks of 256 query rows); at
    S=256 and S=64 the query tile is as tall as S allows, and 128 or 64
    fuller blocks beat 256 blocks cut to fill every SM by 13-37 %."""
    warps, bk, mt, grid, _ = fa._fwd_geometry(B, S, H, D, 2)
    assert (warps, bk, mt, grid[0] * grid[1]) == expect
    assert (grid[0] * grid[1] >= fa.NUM_SMS) == (S == 1024)


@pytest.mark.parametrize("B,S,H,D,warps", [
    (2, 1000, 2, 128, 4), (4, 1024, 4, 32, 8), (4, 256, 4, 64, 4),
    (4, 64, 4, 64, 1)], ids=["B2_S1000_D128", "B4_S1024", "B4_S256", "B4_S64"])
def test_small_batches_keep_half_the_sms_busy(B, S, H, D, warps):
    """A small B*H (SuperDiff at batch 4: 16) stops the query tile growing
    once the grid would give fewer than 64 blocks (about half the SMs)."""
    got, _, _, grid, _ = fa._fwd_geometry(B, S, H, D, 2)
    assert got == warps
    assert grid[0] * grid[1] >= fa._MIN_BLOCKS or got == 1


def test_batch_heads_go_on_the_wide_grid_axis():
    """B*H above 65,535 fits (grid x), and a sequence whose query tiles
    overflow grid y raises instead of launching."""
    warps, _, mt, grid, _ = fa._fwd_geometry(16400, 17, 4, 32, 2)
    assert grid == (65600, -(-17 // (16 * mt * warps)))
    with pytest.raises(ValueError, match="grid"):
        fa._fwd_geometry(1, 256 * 65536 + 1, 1, 32, 2)


@pytest.mark.parametrize("elem_size", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("D", [32, 64, 128])
def test_padded_rows_keep_ldmatrix_free_of_bank_conflicts(D, elem_size):
    """Rows are padded by 16 bytes: the row stride is an odd number of
    16-byte units, so 8 consecutive rows (one ldmatrix phase) start in 8
    distinct 16-byte bank groups of the 128-byte bank row."""
    row = fa._row_bytes(D, elem_size)
    assert row % 16 == 0 and (row // 16) % 2 == 1
    assert len({(r * row // 16) % 8 for r in range(8)}) == 8


@pytest.mark.parametrize("S,Skv,D,dtype,design", [
    (4096, 4096, 64, "bfloat16", "wgmma"),
    (1024, 1024, 64, "bfloat16", "wgmma"),
    (1100, 1024, 64, "bfloat16", "wgmma"),
    (4096, 77, 64, "bfloat16", "mma_sync"),
    (256, 256, 64, "bfloat16", "mma_sync"),
    (64, 64, 64, "bfloat16", "mma_sync"),
    (1024, 1024, 32, "bfloat16", "mma_sync"),
    (1000, 1000, 64, "bfloat16", "mma_sync"),
    (1024, 1100, 64, "bfloat16", "mma_sync"),
    (4096, 4096, 128, "bfloat16", "mma_sync"),
    (4096, 4096, 64, "float32", "mma_sync")],
    ids=["sd64", "sd32", "ragged_q", "sd_cross", "w256_S256", "S64",
         "w256_S1024", "S1000", "ragged_kv", "D128", "f32"])
def test_the_wgmma_design_takes_long_bf16_d64_launches_only(S, Skv, D, dtype,
                                                            design):
    """Stable Diffusion's self-attention at 4,096 and 1,024 positions (bf16,
    D = 64; queries may end in a partial tile, keys fill whole 128-key
    tiles) takes the wgmma design; its cross-attention to 77 keys, every
    wide256 launch, short sequences, other head dims and float32 keep the
    mma.sync design."""
    assert fa._fwd_design(S, Skv, D, getattr(torch, dtype)) == design


@pytest.mark.parametrize("B,S,H", [(16, 4096, 5), (16, 1024, 10), (2, 1100, 3),
                                   (1, 1024, 1), (16400, 1024, 4)])
def test_wgmma_geometry_covers_s_and_fits_the_card(B, S, H):
    """One block per 64 query rows of each (batch, head): the blocks cover
    S with no block wholly past it, and the grid fits the card's one grid
    dimension. (The design's ring, registers and shared memory are the
    kernel's own, held by its static_asserts and read back on the card by
    ``test_wgmma_instantiation_fits_without_spills_on_card``.)"""
    rows, grid = fa._fwd_wgmma_geometry(B, S, H)
    per_head = grid[0] // (B * H)
    assert rows == fa._WGMMA_ROWS == 64
    assert grid[0] == per_head * B * H <= 2 ** 31 - 1
    assert per_head * rows >= S > (per_head - 1) * rows
