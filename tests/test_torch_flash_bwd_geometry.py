"""Launch geometry of the flash-attention backward kernels (B2 dQ, B3
dK/dV), on the CPU.

``ops/flash_attention.py::_bwd_geometry`` picks the warps per block, the
rows per looped tile, the m-tiles per warp and the grid from (kernel, B, S,
H, D, dtype); the kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``), where their shared-memory
layout is also checked against ``_bwd_smem_bytes``."""

import itertools

import pytest

from superdiff_torch.ops import _build
from superdiff_torch.ops import flash_attention as fa

KERNELS = ["dq", "dkv"]


@pytest.mark.parametrize("elem_size", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("S", [1, 17, 64, 256, 1000, 1024, 4096])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("kernel", KERNELS)
def test_geometry_covers_s_and_fits_the_card(kernel, D, S, elem_size):
    """Row tiles cover S exactly (no tile past the end) and are no taller
    than needed (one warp, or no warp's rows wholly past S), (bt, mt) is
    the tallest instantiation the kernel is built with that S fills (else
    the shortest), the block has 1-8 warps,
    the shared memory is the kernel's layout and fits in one block's 227
    KB, and both grid dimensions are in range."""
    B, H = 16, 4
    warps, bt, mt, grid, smem = fa._bwd_geometry(kernel, B, S, H, D,
                                                 elem_size)
    rows = 16 * mt * warps
    assert warps in (1, 2, 4, 8)
    assert grid == (B * H, -(-S // rows))
    assert grid[1] * rows >= S > (grid[1] - 1) * rows
    assert warps == 1 or rows <= max(S, 16 * mt)
    tiles = fa._BWD_TILE[(0 if elem_size == 2 else 1, D, kernel)]
    assert (bt, mt) in tiles and list(tiles) == sorted(tiles)
    assert all(t[0] > S for t in tiles if t[0] > bt)
    assert bt <= S or (bt, mt) == tiles[0]
    assert bt % 16 == 0 and (elem_size == 2 or mt == 1)
    assert smem == fa._bwd_smem_bytes(kernel, D, elem_size, warps, bt, mt)
    assert 0 < smem <= fa.MAX_SMEM
    assert 1 <= grid[0] <= 2 ** 31 - 1 and 1 <= grid[1] <= 65535


@pytest.mark.parametrize("kernel,B,S,H,D,expect", [
    ("dq", 16, 1024, 4, 32, (8, 128, 2, 256)),
    ("dq", 16, 256, 4, 64, (8, 128, 1, 128)),
    ("dq", 16, 64, 4, 64, (4, 64, 1, 64)),
    ("dkv", 16, 1024, 4, 32, (8, 128, 2, 256)),
    ("dkv", 16, 256, 4, 64, (8, 128, 1, 128)),
    ("dkv", 16, 64, 4, 64, (4, 64, 1, 64))],
    ids=["dq_S1024_D32", "dq_S256_D64", "dq_S64_D64", "dkv_S1024_D32",
         "dkv_S256_D64", "dkv_S64_D64"])
def test_path_shapes_take_the_measured_geometry(kernel, B, S, H, D, expect):
    """The wide256 path shapes get the geometry that
    tools/tune_flash_bwd.py --sweep measured fastest on the H100
    (PERF.md): (warps, bt, mt, blocks). Device ms, dQ / dK/dV, on the H100
    80GB HBM3 at 700 W: S=1024 D=32 0.04844 / 0.05860 at (8, 128, 2),
    against 0.04922 / 0.05970 at (8, 64, 2); S=256 D=64 0.00932 / 0.01081
    at (8, 128, 1), against 0.00948 / 0.01120 at (8, 64, 1); S=64 D=64
    0.00350 / 0.00401 at (4, 64, 1), against 0.00441 / 0.00508 at
    (4, 128, 1)."""
    warps, bt, mt, grid, _ = fa._bwd_geometry(kernel, B, S, H, D, 2)
    assert (warps, bt, mt, grid[0] * grid[1]) == expect


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("B,S,H,D", [(2, 1000, 2, 128), (4, 1024, 4, 32),
                                     (4, 256, 4, 64), (4, 64, 4, 64)],
                         ids=["B2_S1000_D128", "B4_S1024", "B4_S256",
                              "B4_S64"])
def test_small_batches_keep_half_the_sms_busy(kernel, B, S, H, D):
    """A small B*H (SuperDiff at batch 4: 16) stops the row tile growing
    once the grid would give fewer than 64 blocks (about half the SMs): a
    block has more warps only if the grid keeps at least 64 blocks."""
    warps, _, mt, grid, _ = fa._bwd_geometry(kernel, B, S, H, D, 2)
    assert grid[0] * grid[1] >= fa._MIN_BLOCKS or warps == 1
    if warps < 8 and 32 * mt * warps <= S:
        assert B * H * -(-S // (32 * mt * warps)) < fa._MIN_BLOCKS


@pytest.mark.parametrize("kernel", KERNELS)
def test_batch_heads_go_on_the_wide_grid_axis(kernel):
    """B*H above 65,535 fits (grid x), and a sequence whose row tiles
    overflow grid y raises instead of launching."""
    warps, _, mt, grid, _ = fa._bwd_geometry(kernel, 16400, 17, 4, 32, 2)
    assert grid == (65600, -(-17 // (16 * mt * warps)))
    with pytest.raises(ValueError, match="grid"):
        fa._bwd_geometry(kernel, 1, 256 * 65536 + 1, 1, 32, 2)


def test_unknown_kernel_raises():
    with pytest.raises(ValueError, match="one of"):
        fa._bwd_geometry("dqkv", 16, 1024, 4, 32, 2)


@pytest.mark.parametrize("elem_size", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("kernel", KERNELS)
def test_layout_matches_the_kernel(kernel, D, elem_size):
    """``_bwd_smem_bytes`` is the kernel's ``Layout``, written out: two
    owned tiles of 16 * mt * warps rows, two stages of two bt-row looped
    tiles (plus bt lse and bt delta floats for dK/dV), a 16 x 20-float
    P / dS buffer per warp for float32; rows padded by 16 bytes."""
    code = 0 if elem_size == 2 else 1
    row = D * elem_size + 16
    for (bt, mt), warps in itertools.product(fa._BWD_TILE[(code, D, kernel)],
                                             (1, 2, 4, 8)):
        stats = 2 * bt * 4 if kernel == "dkv" else 0
        expect = (2 * 16 * mt * warps * row + 2 * (2 * bt * row + stats)
                  + (warps * 16 * 20 * 4 if elem_size == 4 else 0))
        assert fa._bwd_smem_bytes(kernel, D, elem_size, warps, bt,
                                  mt) == expect
        assert expect <= fa.MAX_SMEM


@pytest.mark.parametrize("elem_size", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("kernel", KERNELS)
def test_padded_rows_keep_ldmatrix_free_of_bank_conflicts(kernel, D,
                                                          elem_size):
    """Every tile of the layout (the owned Q/dO or K/V rows, each stage's
    looped tiles and statistics) starts on a 16-byte boundary, and rows
    are padded by 16 bytes: the row stride is an odd number of 16-byte
    units, so the 8 consecutive rows of one ldmatrix phase (plain or
    .trans, any tile, any 16-row step) start in 8 distinct 16-byte bank
    groups of the 128-byte bank row."""
    code = 0 if elem_size == 2 else 1
    row = fa._row_bytes(D, elem_size)
    assert row % 16 == 0 and (row // 16) % 2 == 1
    for (bt, mt), warps in itertools.product(fa._BWD_TILE[(code, D, kernel)],
                                             (1, 2, 4, 8)):
        stats = 2 * bt * 4 if kernel == "dkv" else 0
        own = 16 * mt * warps * row
        stages = [2 * own + st * (2 * bt * row + stats) for st in range(2)]
        tiles = [0, own] + [s + off for s in stages for off in (0, bt * row)]
        assert all(t % 16 == 0 for t in tiles)
        assert all((s + 2 * bt * row) % 16 == 0 for s in stages)
        for base in tiles:
            for r0 in range(0, bt, 8):
                groups = {((base + (r0 + r) * row) // 16) % 8
                          for r in range(8)}
                assert len(groups) == 8


def test_built_backward_tiles_are_the_source_instantiations():
    """``_BWD_TILE`` and the instantiations ``csrc/flash_attn_bwd.cu``
    builds (``SUPERDIFF_BWD_TILES``: kernel, dtype code, D, bt, mt) are the
    same set, so every geometry the wrapper picks has a kernel."""
    built = {(code, D, fa._BWD_KERNELS[k], bt, mt)
             for k, code, D, bt, mt in _build.source_tiles(
                 "bwd", "SUPERDIFF_BWD_TILES")}
    assert built == {(*key, *tile) for key, tiles in fa._BWD_TILE.items()
                     for tile in tiles}


def test_built_forward_tiles_are_the_source_instantiations():
    """The same for the forward kernel: ``_FWD_TILE`` against
    ``SUPERDIFF_FWD_TILES`` (dtype code, D, bk, mt)."""
    built = {(code, D): (bk, mt) for code, D, bk, mt in _build.source_tiles(
        "fwd", "SUPERDIFF_FWD_TILES")}
    assert built == fa._FWD_TILE


@pytest.mark.parametrize("which", ["fwd", "bwd"])
def test_sweep_tiles_are_the_sweep_build(which):
    """Each tuning tool's ``sweep_tiles`` reads the tiles its ``--sweep``
    build adds to the source (``SUPERDIFF_*_CASES`` under
    ``SUPERDIFF_*_SWEEP``): some for each bf16 D of the wide256 path, none
    of them already built, each for a (dtype, D[, kernel]) that is built."""
    import importlib

    tool = importlib.import_module(f"superdiff_torch.tools.tune_flash_{which}")
    sweep = tool.sweep_tiles()
    if which == "bwd":
        built = {key: set(tiles) for key, tiles in fa._BWD_TILE.items()}
        path = {(0, D, k) for D in (32, 64) for k in KERNELS}
    else:
        built = {key: {tile} for key, tile in fa._FWD_TILE.items()}
        path = {(0, 32), (0, 64)}
    assert path <= set(sweep) <= set(built)
    for key, tiles in sweep.items():
        assert tiles and len(set(tiles)) == len(tiles)
        assert not set(tiles) & built[key], key
