"""bias_build_i8's host side on the CPU: the slab kernel's launch plan
against the card's limits, its shared-memory layout and the table kernel's
work buffer as the .cu file lays them out, and the cached device LUTs."""

import re
from pathlib import Path

import pytest
import torch

from markushgrapher_torch.ops import bias_build
from markushgrapher_torch.ops.relbias import bucket_lut


def _plan(batch, heads, length, packed, resident=None):
    smem = bias_build.smem_bytes(length, 32, 128, 100, packed)
    if resident is None:
        resident = bias_build.resident_model(smem)
    return bias_build.plan(batch, heads, length, 32, 128, 100, packed,
                           resident)


@pytest.mark.parametrize("length", [1536, 1280, 320, 200])
@pytest.mark.parametrize("batch", [2, 8, 48])
def test_launch_plan_within_card_limits(batch, length):
    packed = length == 1280            # the packed slab's length
    p = _plan(batch, 16, length, packed)
    resident = bias_build.resident_model(p.smem)
    assert bias_build.THREADS <= 1024
    assert p.smem <= bias_build.BLOCK_SMEM
    # one CTA an SM, every SM busy where the items allow
    assert p.smem + 1024 <= bias_build.SM_SMEM and resident == 132
    items = batch * length * -(-length // 16)
    assert p.groups == 4 and p.grid == p.ranges * 4 <= resident
    assert p.ranges == min(33, -(-items // bias_build.THREADS))
    # every item in one range of each group, no range without one: the
    # C entry refuses a split that leaves items out
    assert p.ranges * p.per_cta >= items
    assert (p.ranges - 1) * p.per_cta < items


def test_launch_plan_main_shapes():
    """The slab's shapes: 16 heads (4 groups), 1536 keys (1280 packed), a
    CTA on each of the 132 SMs, ~373 query rows (of 96 items) a CTA at
    B=8."""
    p = _plan(8, 16, 1536, False)
    assert (p.smem, p.grid, p.per_cta) == (177360, 132, 35747)
    p = _plan(8, 16, 1280, True)
    assert (p.smem, p.grid) == (181200, 132)
    p = _plan(1, 16, 200, False, resident=132)
    assert (p.grid, p.ranges, p.per_cta) == (12, 3, 867)
    p = _plan(2, 6, 256, False)                              # padded heads
    assert (p.groups, p.grid) == (2, 2 * 8)


def test_launch_plan_refuses_what_does_not_fit():
    with pytest.raises(ValueError, match="shared memory"):
        bias_build.plan(1, 16, 16384, 32, 128, 100, False, 132)
    with pytest.raises(ValueError, match="shared memory"):   # nb^3 words
        bias_build.smem_bytes(256, 40, 128, 100, False)


def test_plan_mirrors_the_kernel_source():
    """The plan's constants are the .cu file's."""
    src = (Path(bias_build.__file__).parents[1] / "csrc" /
           "bias_build_i8.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kThreads"]) == bias_build.THREADS
    assert "return (nb * nb * (nb + 1) + 3) / 4 * 4;" in src
    assert int(consts["kKeys"]) == bias_build.KEYS
    assert int(consts["kPadKeys"]) == bias_build.PAD_KEYS
    assert int(consts["kBanks"]) == bias_build.BANKS
    assert f"__launch_bounds__(kThreads, {bias_build.SM_CTAS})" in src


@pytest.mark.parametrize("nb,max_distance", [(32, 128), (32, 100), (16, 64)])
def test_device_lut_is_bucket_lut_cached(nb, max_distance):
    lut = bias_build.device_lut(nb, max_distance, "cpu")
    assert lut.dtype == torch.int32
    assert torch.equal(lut, bucket_lut(nb, max_distance, "cpu"))
    assert bias_build.device_lut(nb, max_distance, torch.device("cpu")) is lut


@pytest.mark.parametrize("resident", [1, 3, 4, 132, 264])
def test_launch_plan_any_resident_count(resident):
    """Fewer resident CTAs than head groups still give each group one CTA
    (the grid then runs in more than one wave); more give more ranges."""
    p = _plan(8, 16, 1536, False, resident=resident)
    items = 8 * 1536 * 96
    assert p.ranges == max(1, resident // 4)
    assert p.grid == 4 * p.ranges
    assert p.ranges * p.per_cta >= items > (p.ranges - 1) * p.per_cta


@pytest.mark.parametrize("nb", [8, 16, 31, 32])
def test_table_words_hold_the_table(nb):
    """A group's table: whole 16-byte units (the slab kernel copies it in
    uint4s), every word (b1, bh, bv) at b1 + (nb + 1) * (bh + nb * bv)
    inside it, and the first thing in the slab kernel's shared memory."""
    words = bias_build.table_words(nb)
    assert words % 4 == 0
    assert nb * nb * (nb + 1) <= words < nb * nb * (nb + 1) + 4
    last = (nb - 1) + (nb + 1) * ((nb - 1) + nb * (nb - 1))
    assert last < words
    luts = 257 + 257 // 16 + 1 + 32 * 201
    keys = -(-256 // 16) * 20
    assert bias_build.smem_bytes(256, nb, 128, 100, False) == \
        4 * ((words + luts + 3) // 4 * 4 + 2 * keys)


@pytest.mark.parametrize("length,packed", [(200, False), (320, True),
                                           (1280, True), (1536, False),
                                           (1536, True), (4096, False)])
def test_smem_layout_by_length(length, packed):
    """The keys' rows (centres, and positions when packed) grow with L in
    padded groups of 16 keys; the table and LUTs stay; every shape the
    tests and the main path use fits a CTA, one CTA an SM."""
    fixed = bias_build.smem_bytes(16, 32, 128, 100, False) - 4 * 2 * 20
    keys = -(-length // 16) * 20
    smem = bias_build.smem_bytes(length, 32, 128, 100, packed)
    assert smem == fixed + 4 * (3 if packed else 2) * keys
    assert smem % 16 == 0
    assert bias_build.resident_model(smem) == 132
