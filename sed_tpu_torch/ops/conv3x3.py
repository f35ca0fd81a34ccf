"""The eval-mode 3x3 convolutions of the conv stack on Hopper's tensor
cores: the wrapper of the CUDA kernel ``csrc/conv3x3.cu``.

``conv3x3(x, weight, planes)`` is ``F.conv2d(x, weight, padding=1)`` for
a (B, Cin, H, W) float32 input and a (Cout, Cin, 3, 3) float32 weight, no
bias, stride 1, in 3xTF32: each operand split into two TF32 values, v =
hi + lo, and each product taken as lo_x hi_w + hi_x lo_w + hi_x hi_w,
summed in float32.  That is fp32 accuracy (about 2^-21 a product, below
the rounding of a float32 sum over K = 9 Cin terms); one TF32 pass is not.
A CPU tensor goes to the plain version, ``conv3x3_plain``, the same
arithmetic in three ``F.conv2d`` passes.  A CUDA tensor launches the
kernel, or raises: there is no fallback.

``weight_planes(weight)`` splits the weight once into the kernel's hi and
lo planes; ``models/blocks.Conv2d`` caches them on the module, keyed on
the weight's storage and version.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from sed_tpu_torch import _build
from sed_tpu_torch.ops.logmel_kernel import split_tf32
from sed_tpu_torch.utils.profiling import span

# the kernel's tile (csrc/conv3x3.cu): output pixels and channels a block,
# input channels a stage, floats of one k8 step of one weight plane
BM, BN, BK = 256, 64, 8
_SMEM_LIMIT, _MAX_STAGES = 232448, 4
# x, weight planes, out, work, batch, cin, cout, height, width, pack,
# splits, stream
_ARGTYPES = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7 + (ctypes.c_void_p,)


def conv3x3_plain(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic in torch ops: x and weight split into
    TF32 hi and lo (round to nearest, ties away), the three products
    lo_x hi_w, hi_x lo_w, hi_x hi_w each summed in float32 by
    ``F.conv2d``, the small ones added first."""
    xh, xl = split_tf32(x)
    wh, wl = split_tf32(weight)
    return (F.conv2d(xl, wh, padding=1) + F.conv2d(xh, wl, padding=1)) \
        + F.conv2d(xh, wh, padding=1)


def _steps(cin: int) -> tuple:
    """(channel blocks, k8 steps a block): a 1-channel input takes its 9
    taps as K in two steps; any other takes 8 channels a tap a step."""
    return (1, 2) if cin == 1 else (-(-cin // BK), 9)


def stages(cin: int, width: int) -> int:
    """Shared-memory stages the kernel runs with for this input (the
    rule of ``layout`` in ``csrc/conv3x3.cu``), 0 where two do not fit (a
    width over ~600)."""
    _, steps = _steps(cin)
    chans = 1 if cin == 1 else BK
    rows = (BM - 1 + width - 1) // width + 3
    ps = -(-(rows * (width + 8) + 24) // 32) * 32 - 24
    stage = -(-(2 * steps * BN * 8 * 4 + chans * ps * 4) // 128) * 128
    n = (_SMEM_LIMIT - 2 * _MAX_STAGES * 8 - 1024) // stage
    return 0 if n < 2 else min(n, _MAX_STAGES)


def takes(x: torch.Tensor) -> bool:
    """Whether the kernel takes a (B, Cin, H, W) input of this width."""
    return x.dim() == 4 and x.shape[1] > 0 and x.shape[3] > 0 \
        and stages(x.shape[1], x.shape[3]) > 0


def weight_planes(weight: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3) float32 -> the kernel's B operand: (Cout / 64
    tiles, channel blocks, hi | lo, k8 steps, 512) floats, Cout and Cin
    zero-padded to whole blocks.  A step's 64 x 8 (channel, k) slice is
    laid out as wgmma's no-swizzle K-major core matrices: (channel // 8,
    k // 4, channel % 8, k % 4).  Column k of a step is input channel k of
    the block at that tap, or, for a 1-channel input, tap 8 step + k."""
    cout, cin = weight.shape[:2]
    blocks, steps = _steps(cin)
    tiles = -(-cout // BN)
    w = weight.detach().to(torch.float32).reshape(cout, cin, 9)
    if cin == 1:
        k = F.pad(w[:, 0], (0, 16 - 9)).reshape(cout, 1, steps, 8)
    else:
        k = F.pad(w, (0, 0, 0, blocks * BK - cin)).reshape(
            cout, blocks, BK, 9).transpose(2, 3)       # (n, block, tap, c)
    k = F.pad(k, (0, 0, 0, 0, 0, 0, 0, tiles * BN - cout))
    hi, lo = split_tf32(k.contiguous())
    p = torch.stack([hi, lo], dim=2)                    # (n, blk, 2, step, k)
    p = p.reshape(tiles, 8, 8, blocks, 2, steps, 2, 4)  # n -> (tile, nc, r)
    # -> (tile, block, plane, step, nc, kc, r, e)
    return p.permute(0, 3, 4, 5, 1, 6, 2, 7).contiguous().reshape(
        tiles, blocks, 2, steps, BN * 8)


def images_a_tile(batch: int, height: int, width: int) -> int:
    """How many images the kernel lays into one group of its BM-pixel
    tiles, one under another with a zero row between two: 1 for a plane
    of over BM / 2 pixels, else floor(BM / ((H + 1) W)) (an image's rows
    and one zero row), at most the batch.  CNN14's 15 x 2 planes take 8,
    its 31 x 4 planes 2; the 4-block stack's planes (62 x 8 and up) 1."""
    if height * width > BM // 2:
        return 1
    return max(1, min(batch, BM // ((height + 1) * width)))


def m_tiles(batch: int, height: int, width: int) -> int:
    """The kernel's tiles of BM output pixels over the batch: ceil(B / g)
    groups of g = ``images_a_tile`` images, each ceil(rows W / BM)
    tiles, where a group has H rows, or g (H + 1) - 1 packed."""
    g = images_a_tile(batch, height, width)
    rows = height if g == 1 else g * (height + 1) - 1
    return -(-batch // g) * -(-(rows * width) // BM)


def products(batch: int, cin: int, cout: int, height: int,
             width: int) -> tuple:
    """(the convolution's operations, those the launched tiles span) of
    one launch, products as 2: 2 B H W Cout 9 Cin, and 2 ``m_tiles`` BM
    ceil(Cout / BN) BN K, where K is the 16 taps of a 1-channel input or
    72 ceil(Cin / 8): a tile holds one image's pixels, or the packed
    images of a small plane with their zero rows (``images_a_tile``), and
    its columns and its K run to whole blocks."""
    k = 16 if cin == 1 else 72 * -(-cin // BK)
    return (2 * batch * height * width * cout * 9 * cin,
            2 * m_tiles(batch, height, width) * BM * -(-cout // BN) * BN * k)


def splits(batch: int, cin: int, cout: int, height: int, width: int,
           sms: int) -> int:
    """How many runs of channel blocks the kernel splits K into: 1 where
    the output tiles (``m_tiles`` of them a column of BN channels, packed
    groups counted once) fill the ``sms`` SMs, else enough runs (none
    empty) to bring the blocks to about one each."""
    tiles = m_tiles(batch, height, width) * -(-cout // BN)
    blocks, _ = _steps(cin)
    if tiles >= sms or blocks == 1:
        return 1
    per = -(-blocks // min(blocks, -(-sms // tiles)))
    return -(-blocks // per)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def conv3x3(x: torch.Tensor, weight: torch.Tensor,
            planes: torch.Tensor = None) -> torch.Tensor:
    """(B, Cin, H, W) -> (B, Cout, H, W), ``F.conv2d(x, weight,
    padding=1)`` in 3xTF32.  The CUDA kernel for a CUDA tensor, in a
    ``sed::conv.3x3`` span, on ``planes`` (``weight_planes(weight)``,
    made here when None); ``conv3x3_plain`` for a CPU tensor.

    The kernel takes a contiguous float32 ``x`` and a float32 weight of
    ``x``'s channel count on its device, at a width ``takes`` allows.  It
    has no backward, and a ctypes call is invisible to autograd, so a
    CUDA input that would want a gradient raises instead of coming back
    silently detached.  ``conv3x3.launches`` counts kernel launches,
    ``conv3x3.packed`` those whose tiles hold several images
    (``images_a_tile`` over 1), ``conv3x3.flop`` and
    ``conv3x3.tile_flop`` their ``products``."""
    if x.device.type == 'cpu':
        return conv3x3_plain(x, weight)
    with span('conv.3x3'):
        return _launch(x, weight, planes)


def _launch(x, weight, planes) -> torch.Tensor:
    """``conv3x3``'s kernel on a card tensor, or a ValueError."""
    if x.device.type != 'cuda':
        raise ValueError(f'conv3x3: unsupported device {x.device}')
    if x.dtype != torch.float32 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f'conv3x3 wants a contiguous (B, C, H, W) float32 '
                         f'tensor, got {tuple(x.shape)} {x.dtype}'
                         f'{"" if x.is_contiguous() else " (strided)"}')
    b, cin, h, w = x.shape
    if weight.dtype != torch.float32 or weight.dim() != 4 or \
            tuple(weight.shape[1:]) != (cin, 3, 3) or \
            weight.device != x.device:
        raise ValueError(f'conv3x3 wants a float32 (Cout, {cin}, 3, 3) '
                         f'weight on {x.device}, got {tuple(weight.shape)} '
                         f'{weight.dtype} on {weight.device}')
    if torch.is_grad_enabled() and (x.requires_grad or weight.requires_grad):
        raise ValueError('conv3x3 has no backward: the CUDA kernel would '
                         'cut the graph of a tensor that requires grad')
    if not takes(x) or h * w >= 2 ** 31:
        raise ValueError(f'conv3x3 takes planes of under 2^31 floats and '
                         f'widths whose halo tile fits shared memory, got '
                         f'{h} x {w} with {cin} channels')
    cout = weight.shape[0]
    blocks, steps = _steps(cin)
    if planes is None:
        planes = weight_planes(weight)
    if planes.shape != (-(-cout // BN), blocks, 2, steps, BN * 8) or \
            planes.dtype != torch.float32 or planes.device != x.device \
            or not planes.is_contiguous():
        raise ValueError(f'conv3x3: planes {tuple(planes.shape)} '
                         f'{planes.dtype} on {planes.device} are not '
                         f'weight_planes of a {tuple(weight.shape)} weight')
    out = torch.empty((b, cout, h, w), dtype=torch.float32, device=x.device)
    if not out.numel():
        return out
    pack = images_a_tile(b, h, w)
    n = splits(b, cin, cout, h, w, _sms(x.device.index))
    work = torch.empty(n * out.numel(), dtype=torch.float32,
                       device=x.device) if n > 1 else None
    _build.launch('conv3x3', _ARGTYPES, x.device, x.data_ptr(),
                  planes.data_ptr(), out.data_ptr(),
                  None if work is None else work.data_ptr(), b, cin, cout,
                  h, w, pack, n)
    flop, tile_flop = products(b, cin, cout, h, w)
    conv3x3.launches += 1
    conv3x3.packed += pack > 1
    conv3x3.flop += flop
    conv3x3.tile_flop += tile_flop
    return out


conv3x3.launches = 0
conv3x3.packed = 0
conv3x3.flop = 0
conv3x3.tile_flop = 0
