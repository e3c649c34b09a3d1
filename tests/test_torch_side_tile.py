"""The host side of the K2b ring tile (csrc/side_tile.cuh): the span each
side block owns and the SK it takes. The tile's arithmetic is
held against JAX in tests/test_torch_absorb_vit.py and tests/test_torch_w8a8.py
(the plain version, on the CPU) and against its plain version on the card
in tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from open_flamingo_tpu_torch.ops import dense_stream as ds
from open_flamingo_tpu_torch.ops.dense_stream import check_side_kernel, side_span

SHAPES = [(16896, 1024), (2112, 1024), (2112, 1000), (16896, 1000), (130, 160), (64, 256), (640, 4096),
          (2112, 1280), (8448, 512)]


def blocks_of(m, sn, span):
    """The ring tile's side grid as csrc/side_tile.cuh `tile_ring` walks it:
    block -> (first row, first column, end column)."""
    spans = -(-sn // span)
    return [(blk // spans * ds.SIDE_ROWS, blk % spans * span, min(blk % spans * span + span, sn))
            for blk in range(-(-m // ds.SIDE_ROWS) * spans)]


@pytest.mark.parametrize("sms", [132, 8])
@pytest.mark.parametrize("m,sn", SHAPES)
def test_side_span_covers_each_output_once(m, sn, sms):
    span = side_span(m, sn, sms)
    assert span % ds.SIDE_PASS == 0 and ds.SIDE_PASS <= span <= -(-sn // ds.SIDE_PASS) * ds.SIDE_PASS
    passes = -(-sn // ds.SIDE_PASS)
    assert passes % (span // ds.SIDE_PASS) == 0          # equal spans of whole passes
    cover = np.zeros((-(-m // ds.SIDE_ROWS), sn), dtype=np.int32)
    blocks = blocks_of(m, sn, span)
    for m0, c0, c_end in blocks:
        assert c0 < c_end
        cover[m0 // ds.SIDE_ROWS, c0:c_end] += 1
    assert (cover == 1).all()
    row_blocks = cover.shape[0]
    if row_blocks * passes >= sms:                        # M allows a full card
        assert len(blocks) >= sms
    else:
        assert span == ds.SIDE_PASS
    if row_blocks >= sms:
        assert span >= sn                                # the row blocks alone fill the card: one span
    else:                                                 # the widest split that fills it
        wider = [p * ds.SIDE_PASS for p in range(span // ds.SIDE_PASS + 1, passes + 1) if passes % p == 0]
        assert all(row_blocks * (passes * ds.SIDE_PASS // w) < sms for w in wider)


def test_side_span_at_the_pipe_and_at_b8():
    # the B 64 pipe: 264 row blocks, each over all 1,024 columns; B 8: 33 row blocks x 4 spans of 256
    assert side_span(16896, 1024, 132) == 1024
    assert side_span(2112, 1024, 132) == 256 and len(blocks_of(2112, 1024, 256)) == 132
    assert side_span(2112, 1024, 8) == 1024


def operands(sk, dtype, int8_tile):
    side_x = torch.zeros(64, sk, dtype=dtype)
    if int8_tile:
        return side_x, torch.zeros(64, sk, dtype=torch.int8), torch.ones(64)
    return side_x, torch.zeros(64, sk, dtype=dtype), None


@pytest.mark.parametrize("dtype,int8_tile", [(torch.bfloat16, False), (torch.bfloat16, True), (torch.float32, True)])
def test_check_side_kernel_refuses_sk_beyond_the_ring(dtype, int8_tile):
    x, w, ws = operands(ds.SIDE_MAX_K, dtype, int8_tile)
    check_side_kernel(x, w, ws, None, None, None)        # ViT-L/14's width, the largest SK the ring takes
    x, w, ws = operands(ds.SIDE_MAX_K + 32, dtype, int8_tile)
    with pytest.raises(ValueError) as err:
        check_side_kernel(x, w, ws, None, None, None)
    for number in (f"got SK {ds.SIDE_MAX_K + 32}", f"SK up to {ds.SIDE_MAX_K}", f"{ds.SIDE_ROWS} rows"):
        assert number in str(err.value)


@pytest.mark.parametrize("sk", [32, 96, 512, 1024])
@pytest.mark.parametrize("dtype,int8_tile", [(torch.bfloat16, False), (torch.bfloat16, True)])
def test_check_side_kernel_takes_sk_up_to_the_ring_limit(dtype, int8_tile, sk):
    check_side_kernel(*operands(sk, dtype, int8_tile), None, None, None)


def test_check_side_kernel_fp32_tile_takes_any_sk():
    x, w, _ = operands(4096, torch.float32, False)      # the fp32 tile stages K in chunks of 32
    check_side_kernel(x, w, None, None, None, None)


@pytest.mark.parametrize("dtype,int8_tile", [(torch.bfloat16, False), (torch.bfloat16, True),
                                             (torch.float32, False)])
def test_check_side_kernel_refuses_sk_not_a_multiple_of_32(dtype, int8_tile):
    x, w, ws = operands(96 + 16, dtype, int8_tile)
    with pytest.raises(ValueError, match="SK a multiple of 32, got 112"):
        check_side_kernel(x, w, ws, None, None, None)

