"""Device-side dequantization of the audio wire (counterpart of
``sed_tpu/ops/wire.py``).

Wire formats, recognised from dtype + buffer width, decoded with torch
ops on the tensor's device:

* float32 — passthrough.
* int16 PCM — ``x / 32767``.
* uint8 G.711 mu-law (width == samples) — 256-entry table gather.
* uint8 qN block-scaled (N in ``audio_io.QN_BITS``) — N-bit codes per
  128-sample block packed big-endian, float16 block scales appended.
  Decoded with static slices per bit-phase group (sample bit offsets
  repeat every lcm(8, N) bits), the scales bit-cast to float16 and
  multiplied in float32.
* uint8 IMA ADPCM at 4, 3 and 2 bits per code — both recurrences of the
  codec (step index, predictor) are chains of saturating adds.  On the
  card one launch of the CUDA kernel ``csrc/adpcm_decode.cu`` decodes the
  batch (``_adpcm_decode``: persistent CUDA blocks walk runs of 8 ADPCM
  blocks, each run's bytes brought in by a TMA bulk copy, a warp per
  ADPCM block resolving both chains by warp scans of clamp-add
  transforms, the run's samples stored as float4); on the CPU the plain
  version ``_adpcm_decode_plain``
  resolves them by a blocked two-level prefix
  (``_resolve_clamp_add_chain``) in int32.  Both are bit-exact to
  ``sed_tpu``'s numpy decoders.

Every uint8 width is tied to the decoded clip length: ``dequant_wire``
needs ``samples`` for a uint8 buffer, and rejects a width that is no
wire's.

The v6 wire (``audio_io.v6_encode_clip``, the lossless variable-rate
re-pack of q6) has a byte length per clip, so a batch comes as one flat
int32 word pool and per-clip word offsets: ``dequant_v6_pool``.  On the
card the whole decode (header parse, width prefix sums, word gathers,
sub-group unpacks and the 128-step predictor recurrence of each (clip,
block) lane) is one launch of the CUDA kernel ``csrc/v6_decode.cu``; on
the CPU the plain version ``_v6_decode_plain`` does it in vectorised torch
integer ops (``v6_fields``) and a loop over the steps
(``_v6_predict_plain``).

On a CUDA tensor a wrapper launches its kernel or raises; it never falls
back to the plain version, which runs only for CPU tensors.  The kernels
are built at first use (``_build.load``); ``_adpcm_decode.launches`` and
``dequant_v6_pool.launches`` count their launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from sed_tpu_torch import _build
from sed_tpu_torch.data import audio_io

_ADPCM_GROUP = 24   # prefix block of the ADPCM chains; divides 504/672/1008


def wire_widths(samples: int) -> dict:
    """Map uint8 wire width -> decode tag for a clip of ``samples``: a qN
    bit count (int) or ``'adpcm4'`` / ``'adpcm3'`` / ``'adpcm2'``.  ADPCM
    widths are odd (trailing pad bytes) while every qN and mu-law width
    is even, so the width-keyed dispatch is collision-free — asserted
    here, not assumed (as ``sed_tpu``'s, these asserts also fire at
    sample counts where the padded ADPCM width equals ``samples``, e.g.
    257)."""
    widths: dict = {}
    if samples % audio_io.Q4_BLOCK == 0:
        widths = {audio_io.qn_bytes(samples, n): n
                  for n in audio_io.QN_BITS}
    aw = audio_io.adpcm_bytes(samples)
    assert aw % 2 == 1 and aw not in widths and aw != samples, (
        samples, aw)
    widths[aw] = 'adpcm4'
    for n in (2, 3):
        w = audio_io.adpcm_n_bytes(samples, n)
        assert w % 2 == 1 and w not in widths and w != samples, (
            samples, n, w)
        widths[w] = f'adpcm{n}'
    return widths


def dequant_wire(wav: torch.Tensor, samples: int | None = None
                 ) -> torch.Tensor:
    """(B, W) wire buffer -> (B, samples) float32 on the same device.

    ``samples`` (the decoded clip length) is required for uint8 buffers:
    a qN buffer whose width were taken as ``samples`` would mis-decode
    through the mu-law table.  uint8 is decoded as ADPCM or qN when its
    width is theirs for ``samples``, as mu-law when width == samples, and
    rejected otherwise.
    """
    if wav.dtype == torch.int16:
        return wav.to(torch.float32) / 32767.0
    if wav.dtype == torch.float32:
        return wav
    if wav.dtype != torch.uint8:
        raise ValueError(f'unsupported wire dtype {wav.dtype}')
    if samples is None:
        raise ValueError(
            'dequant_wire: uint8 wire buffers need an explicit `samples` '
            '(decoded clip length): the buffer width alone cannot tell '
            'mu-law from the narrower qN wires')
    width_tags = wire_widths(samples)
    tag = width_tags.get(wav.shape[-1])
    if isinstance(tag, str):
        return _adpcm_decode(wav, samples, bits=int(tag[5:]))
    if tag is not None:
        return _qn_decode(wav, samples, tag)
    if wav.shape[-1] != samples:
        raise ValueError(
            f'dequant_wire: uint8 buffer width {wav.shape[-1]} is neither '
            f'a qN or ADPCM wire width for {samples} samples '
            f'({sorted(width_tags)}) nor the mu-law width (== samples)')
    return _mulaw_table(wav.device)[wav.long()]


@functools.lru_cache(maxsize=8)
def _mulaw_table(device: torch.device) -> torch.Tensor:
    return torch.from_numpy(audio_io.mulaw_decode_table()).to(device)


def _unpack_codes(data: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., nbytes) uint8-valued int32, a big-endian bitstream of
    ``bits``-bit codes -> (..., nbytes * 8 // bits) codes.  Each code's
    byte offsets within a group of lcm(8, bits) bits are static."""
    gbytes = bits // math.gcd(8, bits)
    gsamples = gbytes * 8 // bits
    lead = data.shape[:-1]
    groups = data.reshape(*lead, data.shape[-1] // gbytes, gbytes)
    parts = []
    for k in range(gsamples):
        j = (k * bits) >> 3
        sh = 16 - bits - ((k * bits) & 7)
        hi = groups[..., j]
        lo = groups[..., min(j + 1, gbytes - 1)]
        parts.append((((hi << 8) | lo) >> sh) & ((1 << bits) - 1))
    return torch.stack(parts, dim=-1).reshape(*lead, -1)


def _qn_decode(wav: torch.Tensor, samples: int, bits: int) -> torch.Tensor:
    b = wav.shape[0]
    nb = samples * bits // 8
    top = (1 << (bits - 1)) - 1
    scale = wav[:, nb:].contiguous().view(torch.float16).to(torch.float32)
    q = _unpack_codes(wav[:, :nb].to(torch.int32), bits)
    x = (q - top - 1).to(torch.float32)
    x = x.reshape(b, samples // audio_io.Q4_BLOCK,
                  audio_io.Q4_BLOCK) * scale[:, :, None]
    return x.reshape(b, samples)


def _adpcm_split(wav: torch.Tensor, bits: int):
    """(B, wire) uint8 -> per-(clip, block) lanes: initial predictor,
    initial step index, and the (lanes, spb - 1) code stream.  bits=4 is
    IMA nibble packing (low nibble first); adpcm3 / adpcm2 pack their
    codes as a big-endian bitstream."""
    ba = audio_io.ADPCM_BLOCK_ALIGN
    spb = audio_io.adpcm_n_samples_per_block(bits, ba)
    b = wav.shape[0]
    nbl = (wav.shape[-1] - audio_io.ADPCM_N_PAD[bits]) // ba
    blocks = wav[:, :nbl * ba].reshape(b * nbl, ba).to(torch.int32)
    pred0 = blocks[:, 0] | (blocks[:, 1] << 8)
    pred0 = torch.where(pred0 >= 32768, pred0 - 65536, pred0)
    idx0 = blocks[:, 2].clamp(0, 88)
    data = blocks[:, 4:]
    if bits == 4:
        codes = torch.stack([data & 0xF, data >> 4], dim=-1).reshape(
            b * nbl, spb - 1)
    else:
        codes = _unpack_codes(data, bits)
    return pred0, idx0, codes, b, nbl, spb


def _resolve_clamp_add_chain(a: torch.Tensor, lo: int, hi: int,
                             x0: torch.Tensor, group: int) -> torch.Tensor:
    """States ``x_t = clip(x_{t-1} + a_t, lo, hi)`` after every step t.

    ``a`` is (L, T) int32, ``x0`` (L,).  The transforms ``x -> clip(x +
    a, l, u)`` are closed under composition: applying (a1, l1, u1) then
    (a2, lo, hi) is (a1 + a2, clip(l1 + a2, lo, hi), clip(u1 + a2, lo,
    hi)).  T is cut into groups of ``group`` steps: (1) the inclusive
    prefix transforms within every group, ``group - 1`` sequential steps
    each over all groups and lanes at once (the sums are one cumsum);
    (2) the state carried across group boundaries, one step per group
    on (L,) arrays; (3) one elementwise application of the prefixes to
    each group's start state.  About 2 * sqrt(T) steps instead of T.
    """
    lanes, t_len = a.shape
    ng = t_len // group
    assert ng * group == t_len, (t_len, group)
    ta = a.reshape(lanes, ng, group)
    pa = ta.cumsum(dim=-1, dtype=torch.int32)
    # lower and upper bounds of the prefix transforms, group-major so
    # that every step writes a contiguous slice
    ta_g = ta.permute(2, 0, 1)                         # (group, L, ng)
    bounds = torch.empty((group, 2, lanes, ng), dtype=torch.int32,
                         device=a.device)
    bounds[0, 0] = lo
    bounds[0, 1] = hi
    for j in range(1, group):
        torch.add(bounds[j - 1], ta_g[j], out=bounds[j]).clamp_(lo, hi)
    pl = bounds[:, 0].permute(1, 2, 0)                 # (L, ng, group)
    pu = bounds[:, 1].permute(1, 2, 0)
    xs = [x0]
    for k in range(ng - 1):
        xs.append(torch.clamp(xs[-1] + pa[:, k, -1], pl[:, k, -1],
                              pu[:, k, -1]))
    x_start = torch.stack(xs, dim=-1)                   # (L, ng)
    x_all = torch.clamp(x_start[:, :, None] + pa, pl, pu)
    return x_all.reshape(lanes, t_len)


@functools.lru_cache(maxsize=16)
def _adpcm_tables(bits: int, device: torch.device):
    return (torch.from_numpy(audio_io.IMA_STEP_TABLE).to(device),
            torch.from_numpy(audio_io.adpcm_index_table(bits)).to(device))


def _adpcm_decode_plain(wav: torch.Tensor, samples: int, bits: int
                        ) -> torch.Tensor:
    """IMA ADPCM decode at ``bits`` per code in torch ops, bit-exact to
    ``audio_io.adpcm_decode_np`` (4) / ``adpcm_n_decode_np`` (3, 2).

    The step-index chain depends only on the codes; once it is resolved
    the signed ``diff`` of every sample is elementwise (one gather of
    the step table), and the predictor is a second clamp-add chain.
    """
    pred0, idx0, codes, b, nbl, spb = _adpcm_split(wav, bits)
    steps, itab = _adpcm_tables(bits, wav.device)
    idx_after = _resolve_clamp_add_chain(itab[codes.long()], 0, 88, idx0,
                                         _ADPCM_GROUP)
    idx_prev = torch.cat([idx0[:, None], idx_after[:, :-1]], dim=1)
    step = steps[idx_prev.long()]
    diff = step >> (bits - 1)
    for k in range(bits - 2, -1, -1):
        diff = diff + torch.where((codes & (1 << k)) != 0,
                                  step >> (bits - 2 - k), 0)
    signed = torch.where((codes & (1 << (bits - 1))) != 0, -diff, diff)
    preds = _resolve_clamp_add_chain(signed, -32768, 32767, pred0,
                                     _ADPCM_GROUP)
    out = torch.cat([pred0[:, None], preds], dim=1)      # (lanes, spb)
    out = out.reshape(b, nbl * spb)[:, :samples]
    return out.to(torch.float32) / 32768.0


# ---------------------------------------------------------------------------
# The CUDA kernels: plain C interfaces (csrc/<name>.cu), bound with ctypes
# ---------------------------------------------------------------------------

_ARGTYPES = {
    # pool, pool words, offsets, out, clips, samples, stream
    'v6_decode': (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                  ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                  ctypes.c_void_p),
    # wav, clips, width, bits, out, samples, stream
    'adpcm_decode': (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p),
}


def _adpcm_decode(wav: torch.Tensor, samples: int, bits: int
                  ) -> torch.Tensor:
    """(B, width) uint8 IMA ADPCM wire at ``bits`` (4, 3 or 2) per code ->
    (B, samples) float32: the CUDA kernel ``csrc/adpcm_decode.cu`` for a
    CUDA tensor (one launch for the batch; the tensor may start at any
    byte address, e.g. a row slice of odd width), ``_adpcm_decode_plain``
    for a CPU tensor.  ``_adpcm_decode.launches`` counts kernel
    launches."""
    if wav.device.type == 'cpu':
        return _adpcm_decode_plain(wav, samples, bits)
    if wav.device.type != 'cuda':
        raise ValueError(f'_adpcm_decode: unsupported device {wav.device}')
    if bits not in audio_io.ADPCM_N_PAD:
        raise ValueError(f'_adpcm_decode: no {bits}-bit ADPCM wire')
    if wav.dtype != torch.uint8 or wav.dim() != 2 or \
            not wav.is_contiguous():
        raise ValueError(f'_adpcm_decode wants a contiguous (B, width) '
                         f'uint8 tensor, got {tuple(wav.shape)} {wav.dtype}')
    b, width = wav.shape
    nbl = (width - audio_io.ADPCM_N_PAD[bits]) // audio_io.ADPCM_BLOCK_ALIGN
    if samples <= 0 or nbl * audio_io.adpcm_n_samples_per_block(
            bits) < samples:
        raise ValueError(f'_adpcm_decode: a {width}-byte adpcm{bits} row '
                         f'does not hold {samples} samples')
    out = torch.empty((b, samples), dtype=torch.float32, device=wav.device)
    if b:
        _build.launch('adpcm_decode', _ARGTYPES['adpcm_decode'],
                      wav.device, wav.data_ptr(), b, width, bits,
                      out.data_ptr(), samples)
        _adpcm_decode.launches += 1
    return out


_adpcm_decode.launches = 0


# ---------------------------------------------------------------------------
# v6 ragged wire: the lossless variable-rate re-pack of q6
# (``audio_io.v6_encode_clip``'s section comment is the format).  Clips
# have different byte lengths, so a batch arrives as one flat
# little-endian word pool plus per-clip word offsets; the fixed-shape
# gather to the worst-case width happens on the device.
# ---------------------------------------------------------------------------


def _words_to_bytes(w: torch.Tensor) -> torch.Tensor:
    """int32 words (..., W) -> little-endian int32 bytes (..., 4W)."""
    by = torch.stack([w & 0xFF, (w >> 8) & 0xFF,
                      (w >> 16) & 0xFF, (w >> 24) & 0xFF], dim=-1)
    return by.reshape(*w.shape[:-1], w.shape[-1] * 4)


def _v6_predict_plain(r: torch.Tensor, order: torch.Tensor,
                      coef: torch.Tensor, init1: torch.Tensor,
                      init2: torch.Tensor, scale: torch.Tensor
                      ) -> torch.Tensor:
    """The predictor recurrence in torch ops, one step at a time over
    the 128 samples of a block, vectorised over lanes (``sed_tpu``'s
    ``lax.scan`` step): ``q_t = r_t + pred`` with pred 0, ``q_{t-1}``,
    ``2 q_{t-1} - q_{t-2}`` or ``((coef q_{t-1} + 16) >> 5) - q_{t-2}``
    by the lane's order, in int32; returns ``q * scale`` as float32.

    ``r`` is (lanes, 128) int32, the others (lanes,)."""
    qp, qp2 = init1, init2
    q = torch.empty_like(r)
    for t in range(r.shape[1]):
        pred = torch.where(
            order == 1, qp, torch.where(
                order == 2, 2 * qp - qp2, torch.where(
                    order == 3, ((coef * qp + 16) >> 5) - qp2,
                    torch.zeros_like(qp))))
        q[:, t] = r[:, t] + pred
        qp2, qp = qp, q[:, t]
    return q.to(torch.float32) * scale[:, None]


def _i8(v: torch.Tensor) -> torch.Tensor:
    """Unsigned byte values -> their int8 reading, in int32."""
    return ((v + 128) & 255) - 128


def v6_fields(pool: torch.Tensor, offsets: torch.Tensor, samples: int):
    """Everything of a batch of v6 clips but the recurrence, in torch
    ops (the plain version's first half): the (B * nb, 128) int32
    residuals and the per-lane order, coef, init1, init2 (int32) and
    float32 scale that ``_v6_predict_plain`` takes."""
    nb = samples // audio_io.Q4_BLOCK
    nsub = nb * audio_io._V6_NSUB
    hw = audio_io.v6_header_bytes(nb) // 4
    b = offsets.shape[0]
    pmax = pool.shape[0] - 1
    dev = pool.device
    offsets = offsets.to(torch.int32)

    # header: one contiguous gather, then byte fields
    hidx = (offsets[:, None] + torch.arange(hw, dtype=torch.int32,
                                            device=dev)).clamp(0, pmax)
    hby = _words_to_bytes(pool[hidx.long()])               # (B, hw * 4)
    u16 = hby[:, 0:2 * nb:2] | (hby[:, 1:2 * nb:2] << 8)
    scale = torch.where(u16 >= 32768, u16 - 65536, u16).to(
        torch.int16).view(torch.float16).to(torch.float32)  # (B, nb)
    mode = hby[:, 2 * nb:4 * nb:2] | (hby[:, 2 * nb + 1:4 * nb:2] << 8)
    order = mode & 3
    init1 = _i8(hby[:, 4 * nb:5 * nb])
    init2 = _i8(hby[:, 5 * nb:6 * nb])
    coef = _i8(hby[:, 6 * nb:7 * nb])

    shifts = 2 + 3 * torch.arange(audio_io._V6_NSUB, dtype=torch.int32,
                                  device=dev)
    widths = ((mode[:, :, None] >> shifts) & 7).reshape(b, nsub)
    # sub-group data = width words each; offsets by exclusive prefix
    doff = (offsets[:, None] + hw
            + torch.cumsum(widths, dim=1, dtype=torch.int32) - widths)
    didx = (doff[:, :, None] + torch.arange(
        audio_io.V6_BITS, dtype=torch.int32, device=dev)).clamp(0, pmax)
    dby = _words_to_bytes(pool[didx.long()])               # (B, nsub, 24)

    r = torch.zeros((b, nsub, audio_io.V6_SUB), dtype=torch.int32,
                    device=dev)
    for w in range(1, audio_io.V6_BITS + 1):
        codes = _unpack_codes(dby[:, :, :4 * w], w)        # (B, nsub, 32)
        r = torch.where((widths == w)[:, :, None],
                        codes - (1 << (w - 1)), r)
    lanes = b * nb
    return (r.reshape(lanes, audio_io.Q4_BLOCK), order.reshape(lanes),
            coef.reshape(lanes), init1.reshape(lanes),
            init2.reshape(lanes), scale.reshape(lanes))


def _v6_decode_plain(pool: torch.Tensor, offsets: torch.Tensor,
                     samples: int) -> torch.Tensor:
    """The plain version of the pool decode: ``v6_fields`` then the
    recurrence, ~216 torch launches and a 128-step loop."""
    b = offsets.shape[0]
    return _v6_predict_plain(*v6_fields(pool, offsets, samples)).reshape(
        b, samples)


def dequant_v6_pool(pool: torch.Tensor, offsets: torch.Tensor,
                    samples: int) -> torch.Tensor:
    """Decode a batch of v6 clips from a flat word pool.

    ``pool``: (P,) int32 — concatenated per-clip v6 payloads (each a
    multiple of 16 bytes, little-endian), plus >= v6_header_bytes of
    zero tail, so that a padding clip (its offset pointing into the tail)
    decodes to silence.  ``offsets``: (B,) int32 word offset of each
    clip's payload.  Returns (B, samples) float32 on the pool's device,
    bit-identical to ``audio_io.v6_decode_np`` per clip (which is
    bit-identical to the q6 wire's decode).  Indices are clipped to
    ``P - 1`` as ``sed_tpu`` clips them.

    A CUDA pool is decoded by one launch of ``csrc/v6_decode.cu`` (its
    offsets must be a contiguous int32 tensor on the same device); a CPU
    pool by ``_v6_decode_plain``.  ``dequant_v6_pool.launches`` counts
    kernel launches.
    """
    if pool.dtype != torch.int32 or pool.dim() != 1:
        raise ValueError(f'dequant_v6_pool wants a (P,) int32 pool, got '
                         f'{tuple(pool.shape)} {pool.dtype}')
    if samples % audio_io.Q4_BLOCK:
        raise ValueError(f'v6 clips hold whole {audio_io.Q4_BLOCK}-sample '
                         f'blocks, not {samples} samples')
    if pool.device.type == 'cpu':
        return _v6_decode_plain(pool, offsets.to(pool.device), samples)
    if pool.device.type != 'cuda':
        raise ValueError(f'dequant_v6_pool: unsupported device '
                         f'{pool.device}')
    if offsets.dtype != torch.int32 or offsets.dim() != 1 or \
            offsets.device != pool.device or not offsets.is_contiguous():
        raise ValueError(f'dequant_v6_pool wants (B,) contiguous int32 '
                         f'offsets on {pool.device}, got '
                         f'{tuple(offsets.shape)} {offsets.dtype} on '
                         f'{offsets.device}')
    if not pool.is_contiguous() or not 0 < pool.shape[0] < 2 ** 31 or \
            samples <= 0:
        raise ValueError(f'dequant_v6_pool: the kernel takes a contiguous '
                         f'pool of 1 to 2^31 - 1 words and samples > 0, got '
                         f'{pool.shape[0]} words, {samples} samples')
    b = offsets.shape[0]
    out = torch.empty((b, samples), dtype=torch.float32, device=pool.device)
    if b:
        _build.launch('v6_decode', _ARGTYPES['v6_decode'], pool.device,
                      pool.data_ptr(), pool.shape[0], offsets.data_ptr(),
                      out.data_ptr(), b, samples)
        dequant_v6_pool.launches += 1
    return out


dequant_v6_pool.launches = 0
