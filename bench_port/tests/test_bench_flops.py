"""The yardstick's counts against the kernel table of the bring-up (the
forward bounds it printed for K1 at the flagship, K3 at stage 1 and K6 at
stage 4) and against the dense mask."""
import json
import os
import random

import numpy as np
import pytest

from bench_port import flops
from bench_port.reference.layout import (RowSpec, build_layout,
                                         frame_block_inference_layout,
                                         render_dense_mask)

ARCH = dict(hidden_size=3072, num_hidden_layers=32, num_attention_heads=32,
            num_key_value_heads=32, intermediate_size=8192)
N_IMG = 220  # 176 x 320 frames: 11 x 20 patches
SEG = N_IMG + 2


def partition(n, rng):
    """The curriculum's random block partition (stage 4's is drawn from
    random.Random(0) in the kernel table)."""
    k = rng.randint(2, n)
    cuts = sorted(rng.sample(range(1, n), k - 1))
    return tuple(b - a for a, b in zip([0] + cuts, cuts + [n]))


def stage(frames, blocks):
    return build_layout([RowSpec(blocks, "training")], N_IMG,
                        pad_to=2 * frames * SEG)


def fwd_ms(lay, queries=slice(None), keys=slice(None), extra=0):
    L = lay.length
    n_q = len(range(L)[queries])
    n_k = len(range(L)[keys])
    return flops.call_bound_ms(flops.attention_fwd(
        ARCH, lay.batch, n_q, n_k, flops.pairs(lay, queries=queries,
                                               keys=keys), extra))


def bwd_ms(lay, products=flops.BWD_PRODUCTS):
    w = flops.attention_bwd(ARCH, lay.batch, lay.length, flops.pairs(lay))
    w["flops"] *= products / flops.BWD_PRODUCTS
    return flops.call_bound_ms(w)


def test_flagship_decode_bounds():
    lay_c = frame_block_inference_layout(8, 16, N_IMG, False)
    lay_u = frame_block_inference_layout(0, 16, N_IMG, False)
    prefix = 8 * SEG
    assert round(fwd_ms(lay_c, queries=slice(prefix, None)), 4) == 0.2337
    assert round(fwd_ms(lay_u), 4) == 0.1554
    pre = slice(0, prefix)
    assert round(fwd_ms(lay_c, pre, pre, prefix * prefix * 2), 4) == 0.0220


def test_stage1_bias_bounds():
    lay = stage(16, (1,) * 16)
    assert round(fwd_ms(lay), 4) == 0.1762
    # the backward: four products; the bring-up's table counted five
    assert round(bwd_ms(lay), 4) == 0.3524
    assert round(bwd_ms(lay, 5), 4) == 0.4405


def test_stage4_inline_bounds():
    blocks = partition(80, random.Random(0))
    cell = json.load(open(os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "workloads", "videogpt.train_stage4.json")))
    assert tuple(cell["traffic"]["frame_blocks"]) == blocks
    lay = stage(80, blocks)
    assert round(fwd_ms(lay), 4) == 4.0873
    assert round(bwd_ms(lay), 4) == 8.1746
    assert round(bwd_ms(lay, 5), 4) == 10.2183
    assert flops.real_tokens(lay) == 35076


@pytest.mark.parametrize("blocks", [(1, 1, 1), (2, 1), (1, 3, 2)])
def test_pairs_match_the_dense_mask(blocks):
    n_img = 6
    lay = build_layout([RowSpec(blocks, "training")], n_img,
                       pad_to=2 * sum(blocks) * (n_img + 2) + 5)
    dense = render_dense_mask(lay)[0]
    assert flops.pairs(lay) == int(dense.sum())
    pad = lay.kind[0] == 0
    assert flops.pairs(lay, pad_rows=False) == int(dense[~pad].sum())
    tail = 2 * (n_img + 2)
    L = lay.length
    assert flops.pairs(lay, queries=slice(L - tail, L)) == int(
        dense[L - tail:].sum())


def test_bound_takes_the_larger_side():
    assert flops.bound_by(3.35e12, 1.0) == "bytes"
    assert flops.bound_by(1.0, 989e12) == "operations"
    assert np.isclose(flops.bound_ms(3.35e12, 989e12), 1e3)
