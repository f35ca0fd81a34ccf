"""sed_tpu_torch/ops/conv3x3.py and the Conv2d dispatch to it, on the CPU
(no card, no nvcc; the kernel itself is held to float64 and to cuDNN in
``tests/test_torch_cuda.py``).

The plain version repeats the kernel's arithmetic (3xTF32: operands
split into TF32 hi and lo, three products, float32 sums) and must be
fp32-accurate: within 4x of ``F.conv2d``'s float32 error against float64
at the stack's eight layer geometries, where one TF32 pass is not.  The
TF32 rounding is ``cvt.rna``'s.  The kernel's indexing (halo tile, tap
shifts, A fragments, the weight planes' core matrices, split K) is
emulated in numpy.  The dispatch is observed with the card predicate
faked and the wrapper spied.
"""

import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sed_tpu_torch import config
from sed_tpu_torch.models import blocks
from sed_tpu_torch.models.zoo import CnnSed
from sed_tpu_torch.ops import conv3x3 as cv
from sed_tpu_torch.ops.logmel_kernel import tf32_round

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')

# (Cin, Cout) of the stack's eight convolutions
LAYERS = [(1, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256),
          (256, 512), (512, 512)]
# the kernel's and the plain version's error against float64 may be this
# many times F.conv2d's float32 error (the card tests' bound too)
FP32_FACTOR = 4.0


def _bits(*words):
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.int32)) \
        .view(torch.float32)


def test_tf32_round_is_cvt_rna():
    """Round to nearest on the 13 dropped bits, ties away from zero, on
    the magnitude (so negatives mirror positives); subnormals round the
    same way, infinities stay, NaN stays NaN."""
    x = _bits(0x3F801000, 0x3F800FFF, 0x3F801001, 0x3F803000, 0x3F802FFF,
              0xBF801000, 0xBF800FFF, 0x00001000, 0x00000FFF, 0x80001000,
              0x007FF000, 0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001,
              0xFFC00123, 0x00000000, 0x80000000)
    want = _bits(0x3F802000, 0x3F800000, 0x3F802000, 0x3F804000, 0x3F802000,
                 0xBF802000, 0xBF800000, 0x00002000, 0x00000000, 0x80002000,
                 0x00800000, 0x7F800000, 0xFF800000, 0x7FC00000, 0x7FC00000,
                 0xFFC00123, 0x00000000, 0x80000000)
    got = tf32_round(x)
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       want[~nan].view(torch.int32))
    assert not (got[~nan].view(torch.int32) & 0x1FFF).any()
    # 1 + 2^-12 + 2^-23: hi rounds down to 1; lo = 2^-12 (1 + 2^-11) is
    # a tie at TF32's 10 bits and rounds away, to 2^-12 + 2^-22
    hi, lo = cv.split_tf32(torch.tensor([1.0 + 2 ** -12 + 2 ** -23]))
    assert (hi.item(), lo.item()) == (1.0, 2 ** -12 + 2 ** -22)


def _checkpoint_weight(cin: int, cout: int) -> torch.Tensor:
    """The bench checkpoint's weight of the stack layer (cin, cout):
    the scales the convolutions run at."""
    block = {64: 1, 128: 2, 256: 3, 512: 4}[cout]
    name = 'conv2' if cin == cout else 'conv1'
    k = np.load(CKPT)[f'params/conv_block{block}/{name}/kernel']
    return torch.from_numpy(k.astype(np.float32)).permute(3, 2, 0, 1) \
        .contiguous()


def _rel(y, ref):
    return ((y.double() - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize('cin,cout', LAYERS)
@pytest.mark.parametrize('relu', [False, True], ids=['random', 'relu'])
def test_plain_is_fp32_accurate_and_one_tf32_pass_is_not(cin, cout, relu):
    """At each layer of the stack (13 x 12 pixels, batch 2, the bench
    checkpoint's weights), random and post-ReLU inputs: the plain
    3xTF32 version is within FP32_FACTOR of F.conv2d's float32 error
    against float64, and one TF32 pass is not."""
    w = _checkpoint_weight(cin, cout)
    assert w.shape == (cout, cin, 3, 3)
    gen = torch.Generator().manual_seed(cin * 7 + cout + relu)
    x = torch.randn(2, cin, 13, 12, generator=gen)
    if relu:
        x = x.relu()
    ref = F.conv2d(x.double(), w.double(), padding=1)
    fp32 = _rel(F.conv2d(x, w, padding=1), ref)
    plain = _rel(cv.conv3x3_plain(x, w), ref)
    one = _rel(F.conv2d(tf32_round(x), tf32_round(w), padding=1), ref)
    assert plain <= FP32_FACTOR * fp32, (plain, fp32)
    assert one > FP32_FACTOR * fp32, (one, fp32)
    assert torch.equal(cv.conv3x3(x, w), cv.conv3x3_plain(x, w))  # CPU


def _emulate_kernel(x: torch.Tensor, w: torch.Tensor, splits: int):
    """``csrc/conv3x3.cu``'s indexing in numpy, float64 sums: per block
    (image, 256-pixel tile, 64-channel tile, split), the producer's halo
    tile of each stage (rows t0 - 1.., interior from word 4, zeros outside
    the image and past Cin), each thread's A fragment (rows g and g + 8 of
    its warp's 16, columns tq and tq + 4) read at the tap's shift, and B
    read from the weight planes through the no-swizzle K-major
    descriptor (8-row core matrices of 16 bytes a row, leading byte offset
    128, stride byte offset 256); the splits' partials added in order."""
    b_, cin, h, wd = x.shape
    cout, hw = w.shape[0], h * wd
    blocks_, steps = cv._steps(cin)
    chans = 1 if cin == 1 else cv.BK
    per = -(-blocks_ // splits)
    rows = (cv.BM - 1 + wd - 1) // wd + 3
    rs = wd + 8
    ps = -(-(rows * rs + 24) // 32) * 32 - 24
    assert ps % 32 == 8
    planes = cv.weight_planes(w).double().numpy()
    xs = x.double().numpy()
    # thread -> (local pixel, fragment column) for its 4 A values a step
    tid = np.arange(256)
    wg, wq, lane = tid >> 7, (tid >> 5) & 3, tid & 31
    g, tq = lane >> 2, lane & 3
    # B (k, n) of one step: float index of the 8 x 16-byte core matrices
    n = np.arange(cv.BN)
    kk = np.arange(8)
    bidx = (n[None] // 8) * 64 + (kk[:, None] // 4) * 32 \
        + (n[None] % 8) * 4 + kk[:, None] % 4                # (k, n)
    out = np.zeros((splits, b_, cout, hw))
    for b in range(b_):
        for m0 in range(0, hw, cv.BM):
            t0 = m0 // wd
            nrows = (min(m0 + cv.BM, hw) - 1) // wd - t0 + 3
            assert nrows <= rows
            for nt in range(-(-cout // cv.BN)):
                for z in range(splits):
                    acc = np.zeros((cv.BM, cv.BN))
                    for cb in range(z * per, min(blocks_, (z + 1) * per)):
                        halo = np.zeros(chans * ps)
                        for c in range(chans):
                            ci = cb * chans + c
                            for r in range(nrows):
                                t = t0 - 1 + r
                                if ci < cin and 0 <= t < h:
                                    o = c * ps + r * rs + 4
                                    halo[o:o + wd] = xs[b, ci, t]
                        for k in range(steps):
                            a = np.zeros((cv.BM, 8))
                            for j in range(2):
                                for hh in range(2):
                                    px = wg * 128 + j * 64 + wq * 16 + g \
                                        + 8 * hh
                                    m = np.minimum(m0 + px, hw - 1)
                                    t = m // wd
                                    roff = (t - t0 + 1) * rs + m - t * wd + 4
                                    for cc in range(2):
                                        col = tq + 4 * cc
                                        if cin == 1:
                                            tap = 8 * k + col
                                            to = np.where(
                                                tap < 9, (tap // 3 - 1) * rs
                                                + tap % 3 - 1, 0)
                                            a[px, col] = halo[roff + to]
                                        else:
                                            to = (k // 3 - 1) * rs + k % 3 - 1
                                            a[px, col] = halo[col * ps + roff
                                                              + to]
                            bsum = (planes[nt, cb, 0, k][bidx]
                                    + planes[nt, cb, 1, k][bidx])
                            acc += a @ bsum
                    mc = min(cv.BM, hw - m0)
                    nc = min(cv.BN, cout - nt * cv.BN)
                    out[z, b, nt * cv.BN:nt * cv.BN + nc, m0:m0 + mc] = \
                        acc[:mc, :nc].T
    return out.sum(0).reshape(b_, cout, h, wd)


@pytest.mark.parametrize('batch,cin,cout,h,w,splits', [
    (2, 1, 64, 9, 8, 1),        # the taps as K
    (1, 3, 70, 5, 7, 1),        # Cin and Cout padded, a width of 7
    (1, 20, 64, 6, 8, 3),       # split K, the last run short
    (1, 16, 8, 40, 16, 2),      # three pixel tiles, the last ragged
    (1, 9, 64, 300, 1, 1),      # a width of 1: 258 halo rows
])
def test_kernel_indexing_emulated(batch, cin, cout, h, w, splits):
    """The kernel's indexing gives F.conv2d of x and the weights' hi + lo
    in float64 (to float64 rounding)."""
    gen = torch.Generator().manual_seed(cin + cout + h)
    x = torch.randn(batch, cin, h, w, generator=gen)
    wt = torch.randn(cout, cin, 3, 3, generator=gen)
    hi, lo = cv.split_tf32(wt)
    want = F.conv2d(x.double(), hi.double() + lo.double(), padding=1)
    got = _emulate_kernel(x, wt, splits)
    assert np.abs(got - want.numpy()).max() <= 1e-12 * want.abs().max()


@pytest.mark.parametrize('cin,cout', [(1, 64), (3, 70), (64, 128)])
def test_weight_planes_hold_the_split_weights(cin, cout):
    """Each (channel, K column) of each step holds the split weight of the
    tap and input channel the kernel pairs with that column, zeros in the
    padding; the hi plane is TF32 and hi + lo is the weight to 2^-22."""
    gen = torch.Generator().manual_seed(cin)
    w = torch.randn(cout, cin, 3, 3, generator=gen)
    p = cv.weight_planes(w)
    blocks_, steps = cv._steps(cin)
    assert p.shape == (-(-cout // cv.BN), blocks_, 2, steps, cv.BN * 8)
    hi, lo = cv.split_tf32(w)
    for n in range(-(-cout // cv.BN) * cv.BN):
        for cb in range(blocks_):
            for k in range(steps):
                for col in range(8):
                    idx = (n % 64) // 8 * 64 + col // 4 * 32 + n % 8 * 4 \
                        + col % 4
                    if cin == 1:
                        ci, tap = 0, 8 * k + col
                    else:
                        ci, tap = cb * cv.BK + col, k
                    ok = n < cout and ci < cin and tap < 9
                    for plane, src in ((0, hi), (1, lo)):
                        want = src[n, ci, tap // 3, tap % 3].item() if ok \
                            else 0.0
                        assert p[n // 64, cb, plane, k, idx].item() == want
    assert torch.equal(tf32_round(p[:, :, 0]), p[:, :, 0])


def test_splits_fill_the_card_and_leave_no_run_empty():
    # the stack at batch 32: enough tiles
    assert cv.splits(32, 512, 512, 62 * 8, 132) == 1
    assert cv.splits(32, 1, 64, 501 * 64, 132) == 1
    # batch 1: block 4 has 2 x 8 tiles, 64 channel blocks
    assert cv.splits(1, 512, 512, 62 * 8, 132) == 8
    assert cv.splits(1, 256, 512, 62 * 8, 132) == 8
    # one channel block: nothing to split
    assert cv.splits(1, 1, 64, 8, 132) == 1
    assert cv.splits(1, 8, 64, 8, 132) == 1
    for batch in (1, 2, 3, 5):
        for cin in (9, 16, 64, 128, 200, 512):
            for hw in (8, 496, 2000, 8000):
                n = cv.splits(batch, cin, 256, hw, 132)
                blocks_ = -(-cin // cv.BK)
                per = -(-blocks_ // n)
                assert 1 <= n <= blocks_ and (n - 1) * per < blocks_


def test_stages_fit_shared_memory():
    """Four stages at the stack's widths, at least two up to ~600, none
    beyond; the ring and the barriers fit a block's 227 KB."""
    for cin in (1, 64, 128, 256, 512):
        for width in (64, 32, 16, 8):
            assert cv.stages(cin, width) == 4
    for width in (1, 2, 3, 7, 100, 255, 256, 480, 600):
        assert cv.stages(64, width) >= 2, width
    assert cv.stages(64, 700) == 0
    assert cv.takes(torch.empty(1, 64, 5, 600))
    assert not cv.takes(torch.empty(1, 64, 5, 700))
    assert not cv.takes(torch.empty(64, 5, 8))


@pytest.fixture
def on_card(monkeypatch):
    """The card predicate faked true, the wrapper spied: it records what
    the dispatch hands it and runs the plain version."""
    calls = []

    def spy(x, weight, planes=None):
        calls.append((x, weight, planes))
        return cv.conv3x3_plain(x, weight)
    monkeypatch.setattr(blocks, '_on_card', lambda x: True)
    monkeypatch.setattr(cv, 'conv3x3', spy)
    monkeypatch.setattr(blocks.Conv2d, '_searched', set())
    return calls


def _measured():
    return blocks.Conv2d.measured_calls


def test_dispatch_takes_eval_no_grad_fp32_3x3(on_card):
    torch.manual_seed(0)
    block = blocks.ConvBlock(3, 8).eval()
    x = torch.randn(2, 3, 21, 16)
    calls = _measured()
    with torch.no_grad():
        got = block(x)
    assert len(on_card) == 2 and _measured() == calls
    for (xi, w, planes), conv in zip(on_card, (block.conv1, block.conv2)):
        assert xi.is_contiguous() and w is conv.weight
        assert torch.equal(planes, cv.weight_planes(conv.weight))
    with torch.inference_mode():
        block(x.transpose(2, 3).contiguous().transpose(2, 3))  # strided
    assert len(on_card) == 4 and on_card[2][0].is_contiguous()
    # the same forward on the plain ops
    want = blocks.epilogue(cv.conv3x3_plain(x, block.conv1.weight),
                           block.bn1)
    want = blocks.epilogue(cv.conv3x3_plain(want, block.conv2.weight),
                           block.bn2, (2, 2))
    assert torch.equal(got, want)


def test_dispatch_keeps_the_measured_choice_for_the_rest(on_card):
    torch.manual_seed(0)
    x = torch.randn(2, 3, 21, 16)
    calls = _measured()
    # autograd: the parameters want gradients
    block = blocks.ConvBlock(3, 8).eval()
    block(x).sum().backward()
    assert not on_card and _measured() == calls + 2
    # bf16 compute dtype
    with torch.no_grad():
        blocks.ConvBlock(3, 8, dtype=torch.bfloat16).eval()(x)
    assert not on_card and _measured() == calls + 4
    # float64
    with torch.no_grad():
        blocks.ConvBlock(3, 8).double().eval()(x.double())
    assert not on_card and _measured() == calls + 6
    # other geometries: 5 x 5, stride 2, a bias
    for kw in (dict(kernel_size=5, padding=2),
               dict(kernel_size=3, padding=1, stride=2),
               dict(kernel_size=3, padding=1, bias=True),
               dict(kernel_size=3, padding=2, dilation=2)):
        conv = blocks.Conv2d(3, 4, **kw).eval()
        with torch.no_grad():
            conv(x)
    assert not on_card and _measured() == calls + 10
    # training mode
    block.train()
    with torch.no_grad():
        block(x)
    assert not on_card and _measured() == calls + 10


def test_dispatch_rebuilds_the_planes_after_load_state_dict(on_card):
    torch.manual_seed(0)
    block = blocks.ConvBlock(3, 8).eval()
    other = blocks.ConvBlock(3, 8).eval()
    x = torch.randn(1, 3, 9, 8)
    with torch.no_grad():
        block(x)
        block(x)
    first, again = on_card[0][2], on_card[2][2]
    assert again is first                      # cached
    block.load_state_dict(other.state_dict())
    with torch.no_grad():
        block(x)
    fresh = on_card[4][2]
    assert fresh is not first
    assert torch.equal(fresh, cv.weight_planes(other.conv1.weight))
    with torch.no_grad():
        block.conv1.weight.mul_(2.0)           # in place: a new version
        block(x)
    assert torch.equal(on_card[6][2], cv.weight_planes(block.conv1.weight))


def test_dispatch_makes_planes_anew_for_inference_tensor_weights(on_card):
    """Weights made under inference mode have no version counter: the
    planes are made anew each call, so an in-place load is never stale."""
    with torch.inference_mode():
        torch.manual_seed(0)
        block = blocks.ConvBlock(3, 8).eval()
        x = torch.randn(1, 3, 9, 8)
        block(x)
        block.conv1.weight.mul_(2.0)
        block(x)
    assert block.conv1._planes is None
    assert torch.equal(on_card[2][2], cv.weight_planes(block.conv1.weight))


def test_four_block_stack_takes_the_kernel_eight_times(on_card):
    torch.manual_seed(0)
    model = CnnSed(config.AUDIO_16K, conv_channels=(8, 16, 16, 32),
                   temporal='gru', head='att', gru_hidden=16).eval()
    wav = torch.from_numpy(np.random.RandomState(5).uniform(
        -0.5, 0.5, (2, 16000)).astype(np.float32))
    with torch.inference_mode():
        model(wav)
    assert len(on_card) == 8
    assert [c[0].shape[1] for c in on_card] == [1, 8, 8, 16, 16, 16, 16, 32]
