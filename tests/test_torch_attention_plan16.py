"""The 16-bit attention forms' launch plan (``kernels/clover_attention.py:
plan16``), made in Python from the shapes, strides and pointers: the
row tiles of packed (position, head) rows, the grid, the keys a block
stages and the staging route (TMA or cp.async).  The CUDA kernels that
run the plan are held on the card by ``chip_smoke.py``; here the plan's
coverage and routes are held on the CPU."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import clover_attention as ca

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location("chip_smoke_cases",
                                               REPO / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)      # stdlib imports only at module level

# (S, T): one query, a tile exactly, one row past it, S < T, S not a
# multiple of the tile over a longer cache
SIZES = ((1, 1), (1, 1024), (37, 100), (128, 128), (129, 300), (300, 300))


def contiguous_strides(T, KV, d):
    return (T * KV * d, KV * d, d)


def plan_of(B, S, T, H, KV, dq, dv, ptr=0):
    return ca.plan16(B, S, H, KV, dq, dv, ptr, contiguous_strides(T, KV, dq),
                     ptr, contiguous_strides(T, KV, dv))


@pytest.mark.parametrize("size", SIZES, ids=lambda s: f"S{s[0]}T{s[1]}")
@pytest.mark.parametrize("G", range(1, 17))
def test_rows_cover_every_query_once(G, size):
    """Every (b, s, h) row of q is computed by exactly one block, and the
    keys each block stages reach its last row's position and no tile
    further."""
    S, T = size
    B, KV = 2, 2
    H = G * KV
    plan = plan_of(B, S, T, H, KV, 64, 64)
    assert plan.group == G and plan.grid == (KV * B, plan.tiles)
    assert plan.tiles == -(-S * G // ca.ROWS)
    seen = []
    for x in range(plan.grid[0]):
        for y in range(plan.grid[1]):
            rows = ca.tile_rows(plan, S, KV, (x, y))
            assert 0 < len(rows) <= ca.ROWS
            seen += rows
            last = max(T - S + s for _, s, _ in rows)    # its last position
            assert ca.tile_keys(plan, S, T, y) == last // 128 + 1
            # every row of block x is of its batch and its KV head's group
            assert all(h // G == x % KV and b == x // KV
                       for b, _, h in rows)
    assert len(seen) == len(set(seen)) == B * S * H
    assert set(seen) == {(b, s, h) for b in range(B) for s in range(S)
                         for h in range(H)}


def test_tiles_run_with_the_most_keys_first():
    """Block row y = 0 holds the group's last rows (the most keys)."""
    plan = plan_of(4, 1024, 1024, 32, 8, 64, 64)
    keys = [ca.tile_keys(plan, 1024, 1024, y) for y in range(plan.tiles)]
    assert keys == sorted(keys, reverse=True) and keys[0] == 8


def test_main_path_plans():
    """gpt2-xl's scoring (25 heads, G = 1) and jamba's (G = 4): 128 rows a
    block, every K / V tile staged once for the whole group."""
    p = plan_of(4, 1024, 1024, 25, 25, 32, 32)
    assert (p.width, p.group, p.tiles, p.grid, p.route) == \
        (32, 1, 8, (100, 8), "tma")
    p = plan_of(4, 1024, 1024, 32, 8, 64, 64)
    assert (p.width, p.group, p.tiles, p.grid, p.route) == \
        (64, 4, 32, (32, 32), "tma")
    p = plan_of(1, 1024, 1024, 40, 10, 128, 64)
    assert (p.width, p.group, p.tiles, p.grid) == (128, 4, 32, (10, 32))


def _case_route(B, S, T, H, KV, dq, dv):
    return plan_of(B, S, T, H, KV, dq, dv).route


# widths whose rows are not 16-byte multiples stage by cp.async
NOT_TMA = {(20, 12), (7, 5)}


@pytest.mark.parametrize("case", smoke.FLASH16_CASES,
                         ids=lambda c: "B{}S{}T{}H{}KV{}dq{}dv{}".format(*c))
def test_flash16_cases_route(case):
    B, S, T, H, KV, dq, dv = case[:7]
    want = "cp.async" if (dq, dv) in NOT_TMA else "tma"
    assert _case_route(B, S, T, H, KV, dq, dv) == want


@pytest.mark.parametrize("case", smoke.WINDOW_CASES,
                         ids=lambda c: "B{}S{}T{}H{}KV{}dq{}dv{}".format(*c))
def test_window_cases_route(case):
    B, S, T, H, KV, dq, dv = case[:7]
    want = "cp.async" if (dq, dv) in NOT_TMA else "tma"
    assert _case_route(B, S, T, H, KV, dq, dv) == want


@pytest.mark.parametrize("shape", (
    (4, 1024, 25, 25, 32, 32), (1, 1024, 40, 10, 128, 64),
    (2, 1024, 16, 16, 128, 64), (4, 1024, 16, 8, 128, 128),
    (4, 1024, 32, 8, 64, 64), (4, 960, 25, 25, 64, 64)))
def test_timed_shapes_take_tma(shape):
    """Every shape phase 3 times (the five scoring shapes and the gpt2-xl
    window; phi3's window is the second) stages K / V by TMA."""
    B, S, H, KV, dq, dv = shape
    assert _case_route(B, S, S, H, KV, dq, dv) == "tma"


@pytest.mark.parametrize("view, want", (
    ((4, 1000, 960, 25, 80, 64), "tma"),      # the gpt2-xl cache window
    ((2, 150, 130, 2, 13, 7), "cp.async"),    # 26-byte rows
    ((2, 300, 256, 2, 80, 64), "tma")))       # G = 4 over 80-wide rows
def test_cache_window_views_route(view, want):
    """A window ``cache[:, :end, :, :d]`` of a (B, cap, KV, w) cache takes
    the cache's strides: TMA where they are 16-byte multiples."""
    B, cap, end, KV, w, d = view
    cache = torch.zeros(B, cap, KV, w, dtype=torch.bfloat16)
    win = cache[:, :end, :, :d]
    plan = ca.plan16(B, end, 4 * KV, KV, d, d, win.data_ptr(),
                     win.stride()[:3], win.data_ptr(), win.stride()[:3])
    assert plan.route == want


def test_tma_needs_alignment_and_16_byte_strides():
    """A base off 16 bytes, an odd stride or a zero (broadcast) stride
    sends K / V to cp.async."""
    good = contiguous_strides(128, 4, 64)
    assert ca.tma_ready(256, good)
    assert not ca.tma_ready(258, good)
    assert not ca.tma_ready(256, (good[0], good[1], 60))
    assert not ca.tma_ready(256, (good[0], 0, 64))
    assert ca.plan16(1, 8, 8, 4, 64, 64, 256, good, 8, good).route == \
        "cp.async"
