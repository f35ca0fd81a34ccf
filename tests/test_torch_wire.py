"""The uint8 wires of sed_tpu_torch (``ops/wire.py``) against ``sed_tpu``:
the device decode against ``sed_tpu.ops.wire.dequant_wire`` (JAX on the
CPU) and against ``sed_tpu``'s numpy decoders, the v6 pool decode
against ``sed_tpu.ops.wire.dequant_v6_pool``, and the engine's
``predict_clips`` on each wire against ``sed_tpu``'s engine on the same
buffers.  On the CPU the decodes run their plain versions; the CUDA
kernels' decomposition of the ADPCM chains (``csrc/adpcm_decode.cu``) is
emulated here and held to ``sed_tpu`` too, and seeded random bytes and
words pin what the kernels must match on any input.

Tolerance: none.  Decodes are compared bitwise (``np.array_equal`` of
the float32 bit patterns); events and XML must be identical.  The
buffers are made by ``sed_tpu``'s encoders: the port only decodes.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sed_tpu.config import AUDIO_16K
from sed_tpu.data import audio_io as jax_audio_io
from sed_tpu.models.registry import get_model as jax_get_model
from sed_tpu.ops import wire as jax_wire
from sed_tpu.serve import engine as jax_engine
from sed_tpu.utils.npz_ckpt import load_variables_npz
from sed_tpu_torch.bench_corpus import make_clips
from sed_tpu_torch.data import audio_io
from sed_tpu_torch.compat.from_flax import load_npz
from sed_tpu_torch.ops import wire
from sed_tpu_torch.ops.logmel_kernel import fused_logmel
from sed_tpu_torch.serve import engine

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, 'tools', 'bench_checkpoint.npz')
MODEL = 'Cnn_9layers_Gru_FrameAtt'


@pytest.fixture(scope='module', autouse=True)
def few_threads():
    """Two intra-op threads: the suite runs six test processes on one
    host, and torch's default of one thread per core oversubscribes it."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


ENCODERS = {
    **{f'q{n}': (lambda x, n=n: jax_audio_io.qn_encode(x, n),
                 lambda b, s, n=n: jax_audio_io.qn_decode_np(b, s, n))
       for n in jax_audio_io.QN_BITS},
    'mulaw': (jax_audio_io.mulaw_encode, lambda b, s: jax_audio_io
              .mulaw_decode(b)),
    'adpcm4': (jax_audio_io.adpcm_encode, jax_audio_io.adpcm_decode_np),
    **{f'adpcm{n}': (lambda x, n=n: jax_audio_io.adpcm_n_encode(x, n),
                     lambda b, s, n=n: jax_audio_io.adpcm_n_decode_np(
                         b, s, n))
       for n in (3, 2)},
}


def _signals(samples: int) -> np.ndarray:
    """Seeded noise (with a bench-corpus clip's content), a full-scale
    +-1 square wave and digital silence."""
    rng = np.random.RandomState(samples)
    noise = np.clip(rng.standard_normal(samples) * 0.3, -1, 1)
    corpus = make_clips(1, 16000, seconds=5, seed=1)[0]
    noise[:min(samples, corpus.size)] += corpus[:samples]
    square = np.where((np.arange(samples) // 37) % 2 == 0, 1.0, -1.0)
    return np.clip(np.stack([noise, square, np.zeros(samples)]),
                   -1, 1).astype(np.float32)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


# 80000: 5 s at 16 kHz; 64640 = 128 x 505 = 96 x 673 + 32: the adpcm4
# block divides it, the adpcm3/2 blocks do not (nor do they 80000)
@pytest.mark.parametrize('samples', [80000, 64640])
@pytest.mark.parametrize('name', sorted(ENCODERS))
def test_dequant_wire_bitwise_equal_to_sed_tpu(name, samples):
    encode, decode_np = ENCODERS[name]
    x = _signals(samples)
    buf = encode(x)
    assert buf.dtype == np.uint8
    got = wire.dequant_wire(torch.from_numpy(buf), samples)
    assert got.dtype == torch.float32 and got.shape == (3, samples)
    got = got.numpy()
    assert np.array_equal(_bits(got), _bits(decode_np(buf, samples)))
    if samples == 80000:            # one JAX compile per wire is enough
        want = jax_wire.dequant_wire(jnp.asarray(buf), samples)
        assert np.array_equal(_bits(got), _bits(want))
    # silence stays silent (adpcm2 cannot code a zero step: +-1 LSB)
    assert np.abs(got[2]).max() <= 1e-4
    assert np.abs(got[1]).max() > 0.9            # full scale survives


PORT_CODECS = {
    **{f'q{n}': (lambda x, n=n: audio_io.qn_encode(x, n),
                 lambda b, s, n=n: audio_io.qn_decode_np(b, s, n))
       for n in audio_io.QN_BITS},
    'mulaw': (audio_io.mulaw_encode, lambda b, s: audio_io.mulaw_decode(b)),
    'adpcm4': (audio_io.adpcm_encode_np, audio_io.adpcm_decode_np),
    **{f'adpcm{n}': (lambda x, n=n: audio_io.adpcm_n_encode_np(x, n),
                     lambda b, s, n=n: audio_io.adpcm_n_decode_np(b, s, n))
       for n in (3, 2)},
}


@pytest.mark.parametrize('name', sorted(ENCODERS))
def test_numpy_codecs_equal_sed_tpu(name):
    """The port's copies of the numpy encoders and reference decoders
    (what chip_smoke.py makes and checks its wires with) give
    ``sed_tpu``'s bytes and samples; ``sed_tpu``'s ADPCM encoders run its
    native codec, bit-exact to the numpy one."""
    x = _signals(64640)
    pcm = (x * 32767).astype(np.int16)
    for inp in (x, pcm):
        buf = PORT_CODECS[name][0](inp)
        assert np.array_equal(buf, ENCODERS[name][0](inp))
        assert np.array_equal(_bits(PORT_CODECS[name][1](buf, 64640)),
                              _bits(ENCODERS[name][1](buf, 64640)))


def _v6_pool(rows, tail_words: int = 2048):
    """sed_tpu's pool layout: payloads back to back, a zero tail, the
    word offsets, and one padding row pointing into the tail."""
    sizes = [r.nbytes for r in rows]
    pool = np.concatenate(list(rows) + [np.zeros(4 * tail_words, np.uint8)])
    offsets = np.concatenate([[0], np.cumsum(sizes)]) // 4
    return pool.view(np.int32), offsets.astype(np.int32)


def _v6_signals(samples: int) -> np.ndarray:
    """``tests/test_v6.py``'s edge inputs (silence, DC, 440 Hz and 7.9 kHz
    tones, uniform noise) and a bench-corpus clip."""
    t = np.arange(samples) / 16000
    return np.stack([
        np.zeros(samples), np.ones(samples),
        0.4 * np.sin(2 * np.pi * 440 * t), 0.9 * np.sin(2 * np.pi * 7900 * t),
        np.random.RandomState(3).uniform(-1, 1, samples),
        make_clips(1, 16000, seconds=5, seed=3)[0][:samples]]
    ).astype(np.float32)


@pytest.mark.parametrize('samples', [80000, 16000])
def test_dequant_v6_pool_bitwise_equal_to_sed_tpu(samples):
    """The port's pool decode on the CPU (the predictor's plain version)
    against sed_tpu's JAX ``dequant_v6_pool`` and ``v6_decode_np`` (and
    so q6's decode), with an int16 clip and a padding row that decodes
    to silence."""
    x = _v6_signals(samples)
    pcm = (np.random.RandomState(4).uniform(-1, 1, samples)
           * 32767).astype(np.int16)
    rows = [audio_io.v6_encode_clip(c) for c in x] + \
        [audio_io.v6_encode_clip(pcm)]
    pool, offsets = _v6_pool(rows)
    got = wire.dequant_v6_pool(torch.from_numpy(pool),
                               torch.from_numpy(offsets), samples)
    assert got.dtype == torch.float32 and got.shape == (len(rows) + 1,
                                                        samples)
    got = got.numpy()
    if samples == 80000:            # one JAX compile is enough
        want = jax_wire.dequant_v6_pool(jnp.asarray(pool),
                                        jnp.asarray(offsets), samples)
        assert np.array_equal(_bits(got), _bits(want))
    for i, row in enumerate(rows):
        assert np.array_equal(_bits(got[i]), _bits(
            jax_audio_io.v6_decode_np(row, samples)))
    q6 = jax_audio_io.qn_decode_np(jax_audio_io.qn_encode(x, 6), samples, 6)
    assert np.array_equal(_bits(got[:len(x)]), _bits(q6))
    assert not _bits(got[-1]).any()          # the padding row: +0.0


def test_v6_predictor_plain_keeps_int32_arithmetic():
    """The recurrence's plain version on hand-made lanes of every order,
    with negative products (the arithmetic right shift) and wrapping
    int32 sums, against a step-by-step numpy int32 evaluation."""
    rng = np.random.RandomState(0)
    lanes = 64
    r = rng.randint(-32, 32, (lanes, 128)).astype(np.int32)
    order = np.arange(lanes, dtype=np.int32) % 4
    coef = rng.randint(-128, 128, lanes).astype(np.int32)
    init1 = rng.randint(-128, 128, lanes).astype(np.int32)
    init2 = rng.randint(-128, 128, lanes).astype(np.int32)
    scale = rng.uniform(0.001, 0.03, lanes).astype(np.float32)
    got = wire._v6_predict_plain(*(torch.from_numpy(a) for a in (
        r, order, coef, init1, init2, scale))).numpy()

    def recurrence(dtype):
        qp, qp2 = init1.astype(dtype), init2.astype(dtype)
        q = np.empty(r.shape, dtype)
        for t in range(128):
            pred = np.select([order == 1, order == 2, order == 3],
                             [qp, 2 * qp - qp2,
                              ((coef * qp + 16) >> 5) - qp2], 0)
            q[:, t] = r[:, t] + pred
            qp2, qp = qp, q[:, t]
        return q

    q = recurrence(np.int32)
    assert np.abs(recurrence(np.int64)).max() > 2 ** 31  # order 3 wraps
    assert np.array_equal(_bits(got), _bits(q.astype(np.float32)
                                            * scale[:, None]))
    assert wire.dequant_v6_pool.launches == 0       # the CPU runs plain


ADPCM_BITS = pytest.mark.parametrize('bits', [4, 3, 2])


def _random_adpcm(bits: int, samples: int, rows: int, seed: int
                  ) -> np.ndarray:
    """Seeded random bytes at the adpcm``bits`` wire width: step-index
    bytes mostly > 88 (clamped), codes that saturate the predictor, and
    a row of all-ones bytes (every code the largest negative step)."""
    width = audio_io.adpcm_n_bytes(samples, bits)
    buf = np.random.RandomState(seed).randint(0, 256, (rows, width))
    buf[-1] = 255
    return buf.astype(np.uint8)


def _jax_decode(buf: np.ndarray, samples: int) -> np.ndarray:
    return np.asarray(jax_wire.dequant_wire(jnp.asarray(buf), samples))


@ADPCM_BITS
def test_adpcm_random_bytes_bitwise_equal_to_sed_tpu(bits):
    """What the ADPCM kernel must match on any bytes: the port's plain
    decode against sed_tpu's JAX ``dequant_wire`` and numpy decoder."""
    samples = 16000
    buf = _random_adpcm(bits, samples, 6, seed=bits)
    assert (buf[:, 2::audio_io.ADPCM_BLOCK_ALIGN] > 88).mean() > 0.5
    got = wire.dequant_wire(torch.from_numpy(buf), samples).numpy()
    assert np.abs(got).max() == 1.0                  # the predictor clamps
    assert np.array_equal(_bits(got), _bits(_jax_decode(buf, samples)))
    decode_np = ENCODERS['adpcm4' if bits == 4 else f'adpcm{bits}'][1]
    assert np.array_equal(_bits(got), _bits(decode_np(buf, samples)))


def _warp_scan_chain(a: torch.Tensor, lo: int, hi: int, x0: torch.Tensor,
                     group: int) -> torch.Tensor:
    """The kernel's resolution of ``x_t = clip(x_{t-1} + a_t, lo, hi)``:
    32 threads of ``group`` steps each compose their transforms, an
    inclusive Hillis-Steele scan over the threads (5 rounds of shifts by
    1, 2, 4, 8, 16), each thread's start state from the exclusive prefix,
    then its own steps one by one.  Returns the states after each step."""
    lanes = a.shape[0]
    ta = a.reshape(lanes, 32, group)
    ca = ta.sum(dim=-1, dtype=torch.int32)
    cl = torch.full_like(ca, lo)
    cu = torch.full_like(ca, hi)
    for k in range(group):
        cl = (cl + ta[..., k]).clamp(lo, hi)
        cu = (cu + ta[..., k]).clamp(lo, hi)
    d = 1
    while d < 32:
        pa, pl, pu = (F.pad(x[:, :-d], (d, 0)) for x in (ca, cl, cu))
        on = torch.arange(32) >= d
        nl = torch.minimum(torch.maximum(pl + ca, cl), cu)
        nu = torch.minimum(torch.maximum(pu + ca, cl), cu)
        ca, cl, cu = (torch.where(on, n, x) for n, x in (
            (pa + ca, ca), (nl, cl), (nu, cu)))
        d *= 2
    ea = F.pad(ca[:, :-1], (1, 0))
    el = F.pad(cl[:, :-1], (1, 0), value=lo)
    eu = F.pad(cu[:, :-1], (1, 0), value=hi)
    x = torch.minimum(torch.maximum(x0[:, None] + ea, el), eu)
    out = []
    for k in range(group):
        x = (x + ta[..., k]).clamp(lo, hi)
        out.append(x)
    return torch.stack(out, dim=-1).reshape(lanes, 32 * group)


def _adpcm_kernel_emulation(buf: np.ndarray, samples: int, bits: int,
                            chain) -> np.ndarray:
    """``csrc/adpcm_decode.cu``'s decomposition on the CPU: each block's
    codes padded to 32 threads x G (16, 21 or 32) with the identity
    transform of the chain's own bounds (a = 0), both chains resolved by
    ``chain`` with ``group`` = G, the pads cut."""
    group = {4: 16, 3: 21, 2: 32}[bits]
    pred0, idx0, codes, b, nbl, spb = wire._adpcm_split(
        torch.from_numpy(buf), bits)
    steps, itab = wire._adpcm_tables(bits, torch.device('cpu'))
    pad = 32 * group - codes.shape[1]
    assert 0 <= pad < group
    idx_after = chain(F.pad(itab[codes.long()], (0, pad)), 0, 88, idx0,
                      group)[:, :spb - 1]
    idx_prev = torch.cat([idx0[:, None], idx_after[:, :-1]], dim=1)
    step = steps[idx_prev.long()]
    diff = step >> (bits - 1)
    for k in range(bits - 2, -1, -1):
        diff = diff + torch.where((codes & (1 << k)) != 0,
                                  step >> (bits - 2 - k), 0)
    signed = torch.where((codes & (1 << (bits - 1))) != 0, -diff, diff)
    preds = chain(F.pad(signed, (0, pad)), -32768, 32767, pred0,
                  group)[:, :spb - 1]
    out = torch.cat([pred0[:, None], preds], dim=1).reshape(b, nbl * spb)
    return (out[:, :samples].to(torch.float32) / 32768.0).numpy()


@pytest.mark.parametrize('chain', ['blocked_prefix', 'warp_scan'])
@ADPCM_BITS
def test_adpcm_kernel_decomposition_bitwise_equal_to_sed_tpu(bits, chain):
    """The kernel's padding and grouping, emulated with the blocked
    prefix (``_resolve_clamp_add_chain``, group = codes a thread) and
    with the warp scan itself, on encodings of ``_signals`` and on
    random bytes: bitwise equal to sed_tpu's JAX decode."""
    fn = {'blocked_prefix': wire._resolve_clamp_add_chain,
          'warp_scan': _warp_scan_chain}[chain]
    samples = 16000
    name = 'adpcm4' if bits == 4 else f'adpcm{bits}'
    for buf in (ENCODERS[name][0](_signals(samples)),
                _random_adpcm(bits, samples, 4, seed=10 + bits)):
        want = _jax_decode(buf, samples)
        assert np.array_equal(_bits(_adpcm_kernel_emulation(
            buf, samples, bits, fn)), _bits(want))


ADPCM_RUN = 8                        # csrc/adpcm_decode.cu: kRun
ADPCM_STAGE_BYTES = 8 * 256 + 32     # kStageBytes


def _skew(j):
    """The kernel's staged word of sample j (``skew``)."""
    return j + (j >> 5)


def _index_step(bits: int, c: int) -> int:
    """The kernel's index-table entry computed from the code's bits
    (``index_step``)."""
    if bits == 4:
        return max(2 * (c & 7) - 7, -1) + ((c >> 2) & 1)
    if bits == 3:
        return min(max(2 * (c & 3) - 3, -1), (c & 3) - 1)
    return 3 * (c & 1) - 1


def _table_entry(bits: int, idx: int, c: int) -> int:
    """The kernel's decode-table entry (``table_entry``): the signed diff
    of code c at step index idx times 2^14, plus the next index's row
    offset, the index times 2^(bits + 2)."""
    step = int(audio_io.IMA_STEP_TABLE[idx])
    s = step >> (bits - 1)
    for m in range(bits - 2, -1, -1):
        if c & (1 << m):
            s += step >> (bits - 2 - m)
    if c & (1 << (bits - 1)):
        s = -s
    return s * 2 ** 14 + (min(max(idx + _index_step(bits, c), 0), 88)
                          << (bits + 2))


def _group_entry(bits: int, f: int) -> int:
    """The kernel's group composite (``make_table``'s ``g``): the
    step-index transform (a, l, u) of the 2 (4 and 3 bits) or 4 (2 bits)
    codes whose bits are f, in stream order, packed a << 16 | u << 8 | l.
    """
    n = 4 if bits == 2 else 2
    a, lo, hi = 0, 0, 88
    for i in range(n):
        c = ((f >> (4 * i)) & 15 if bits == 4
             else (f >> (n * bits - bits * (i + 1))) & ((1 << bits) - 1))
        d = _index_step(bits, c)
        a, lo, hi = a + d, min(max(lo + d, 0), 88), min(max(hi + d, 0), 88)
    return a * 65536 + (hi << 8) + lo


def _adpcm_kernel_dataflow(buf: np.ndarray, samples: int, bits: int,
                           start: int) -> np.ndarray:
    """``csrc/adpcm_decode.cu``'s data path for a (rows, width) wire at a
    byte address ``start`` mod 16: each run of up to 8 ADPCM blocks of a
    clip fetched into a stage as its unaligned head, its 16-byte-aligned
    interior (the bulk copy) and its tail; each block decoded from the
    stage by the warp-scan emulation; the samples staged at ``_skew``
    words from the run's output element rounded down to 4, then stored as
    a scalar head, float4 groups (4 consecutive staged words each) and a
    scalar tail.  Asserts the
    alignments, that every wire byte of a block is fetched once and
    nothing outside the tensor, and that every output element is stored
    once."""
    rows, width = buf.shape
    spb = audio_io.adpcm_n_samples_per_block(bits)
    pad = audio_io.ADPCM_N_PAD[bits]
    nbl = (width - pad) // audio_io.ADPCM_BLOCK_ALIGN
    rpc = -(-nbl // ADPCM_RUN)
    mem = np.zeros(start + buf.size + 64, np.uint8)
    mem[start:start + buf.size] = buf.reshape(-1)
    fetched = np.zeros(mem.size, np.int64)
    out = np.full(rows * samples, np.nan, np.float32)
    stored = np.zeros(rows * samples, np.int64)
    words = _skew(3 + ADPCM_RUN * spb + 3) + 1
    for q in range(rows * rpc):
        clip, r = divmod(q, rpc)
        b0 = r * ADPCM_RUN
        blocks = min(ADPCM_RUN, nbl - b0)
        src = start + clip * width + b0 * 256
        lead = src & 15
        head = (16 - lead) & 15
        nbytes = blocks * 256
        body = (nbytes - head) & ~15
        tail = nbytes - head - body
        assert body > 0 and tail < 16 and (src + head) % 16 == 0
        assert (lead + head) % 16 == 0 and lead + nbytes + 4 <= \
            ADPCM_STAGE_BYTES
        stage = np.zeros(ADPCM_STAGE_BYTES, np.uint8)
        for lo, n in ((src, head), (src + head, body),
                      (src + head + body, tail)):
            stage[lead + lo - src:lead + lo - src + n] = mem[lo:lo + n]
            fetched[lo:lo + n] += 1
        blk = stage[lead:lead + nbytes].reshape(blocks, 256)
        dec = _adpcm_kernel_emulation(np.pad(blk, ((0, 0), (0, pad))), spb,
                                      bits, _warp_scan_chain)
        o0 = clip * samples + b0 * spb
        n_out = max(0, min(blocks * spb, samples - b0 * spb))
        smp = np.full(words, np.nan, np.float32)
        smp[_skew((o0 & 3) + np.arange(blocks * spb))] = dec.reshape(-1)
        base, end = o0 & ~3, o0 + n_out
        e0, e1 = (o0 + 3) & ~3, end & ~3
        pieces = [(o0, min(e0, end))]
        if end > e0:
            pieces += [(e0, e1), (e1, end)]
            groups = np.arange(e0, e1, 4) - base
            assert (_skew(groups + 3) == _skew(groups) + 3).all()
        assert pieces[0][1] - o0 < 4 and pieces[-1][1] - pieces[-1][0] < 4
        for lo, hi in pieces:
            e = np.arange(lo, hi)
            out[e] = smp[_skew(e - base)]
            stored[e] += 1
    blocks_bytes = np.zeros(mem.size, bool)
    blocks_bytes[start:start + buf.size] = np.pad(
        np.ones((rows, nbl * 256), bool), ((0, 0), (0, width - nbl * 256))
    ).reshape(-1)
    assert (fetched[blocks_bytes] == 1).all()
    assert not fetched[~blocks_bytes].any()
    assert (stored == 1).all()
    return out.reshape(rows, samples)


@pytest.mark.parametrize('start', [0, 1, 7])
@ADPCM_BITS
def test_adpcm_kernel_dataflow_bitwise_equal_to_sed_tpu(bits, start):
    """The kernel's runs, stages and stores emulated on a wire at byte
    address ``start`` mod 16, at 30000 samples (every width ends a row
    with a part run of 4, 5 or 6 blocks), on encodings and on random
    bytes: bitwise equal to sed_tpu's JAX decode.  The index-table
    entries the kernel computes from the code's bits equal the table, its
    group composites equal their codes' steps applied one by one, and
    its decode table's entries give the signed diff (an arithmetic shift
    right by 14) and the next index's row offset (the low 14 bits) as the
    plain decode computes them."""
    steps, itab = wire._adpcm_tables(bits, torch.device('cpu'))
    codes = torch.arange(1 << bits)
    for c in range(1 << bits):
        assert _index_step(bits, c) == itab[c]
    step = steps[:, None]                                # (89, 1)
    diff = step >> (bits - 1)
    for k in range(bits - 2, -1, -1):
        diff = diff + torch.where((codes & (1 << k)) != 0,
                                  step >> (bits - 2 - k), 0)
    signed = torch.where((codes & (1 << (bits - 1))) != 0, -diff, diff)
    nxt = (torch.arange(89)[:, None] + itab[codes]).clamp(0, 88)
    entries = torch.tensor([[_table_entry(bits, i, c)
                             for c in range(1 << bits)] for i in range(89)])
    assert torch.equal(entries >> 14, signed)
    assert torch.equal(entries & (2 ** 14 - 1), nxt << (bits + 2))
    # a group composite applied to every start index is the group's codes
    # applied one by one (the plain decode's chain)
    n = 4 if bits == 2 else 2
    for f in range(1 << (n * bits)):
        e = _group_entry(bits, f)
        ga, gu, gl = e >> 16, (e >> 8) & 255, e & 255
        cs = ([(f >> (4 * i)) & 15 for i in range(n)] if bits == 4 else
              [(f >> (n * bits - bits * (i + 1))) & ((1 << bits) - 1)
               for i in range(n)])
        x = torch.arange(89)
        for c in cs:
            x = (x + itab[c]).clamp(0, 88)
        assert torch.equal(x, (torch.arange(89) + ga).clamp(gl, gu))
    samples = 30000
    name = 'adpcm4' if bits == 4 else f'adpcm{bits}'
    buf = np.concatenate([ENCODERS[name][0](_signals(samples)[:2]),
                          _random_adpcm(bits, samples, 2, seed=30 + bits)])
    assert (audio_io.adpcm_n_bytes(samples, bits) - audio_io.ADPCM_N_PAD[
        bits]) // 256 % ADPCM_RUN
    got = _adpcm_kernel_dataflow(buf, samples, bits, start)
    assert np.array_equal(_bits(got), _bits(_jax_decode(buf, samples)))


def test_dequant_v6_pool_random_words_bitwise_equal_to_sed_tpu():
    """What the v6 kernel must match on any words: a seeded random-word
    pool (every order and width, width-7 modes, NaN and inf scales),
    one clip whose header makes order 3 wrap int32, offsets into the
    pool's tail, past ``P`` and negative, through the port's plain
    decode and sed_tpu's JAX ``dequant_v6_pool``."""
    samples = 16000
    nb = samples // audio_io.Q4_BLOCK
    hb = audio_io.v6_header_bytes(nb)
    rng = np.random.RandomState(6)
    pool = rng.randint(0, 256, 4 * 6000).astype(np.uint8)
    # words 100..: order 3, coef 127, init1 127, init2 -128, width 6
    head = pool[400:400 + hb]
    head[:2 * nb] = np.frombuffer(np.full(nb, 0.001, np.float16).tobytes(),
                                  np.uint8)
    head[2 * nb:4 * nb] = np.frombuffer(np.full(
        nb, 3 | (6 << 2) | (6 << 5) | (6 << 8) | (6 << 11), np.uint16
    ).tobytes(), np.uint8)
    head[4 * nb:7 * nb] = np.repeat(np.array([127, 128, 127], np.uint8), nb)
    pool[:2] = (0, 0x7c)                        # clip 0, block 0: scale inf
    pool = pool.view(np.int32)
    offsets = np.array([0, 100, 3, 5990, 5999, 7000, -9, 2 ** 31 - 50],
                       np.int32)
    got = wire.dequant_v6_pool(torch.from_numpy(pool),
                               torch.from_numpy(offsets), samples).numpy()
    want = jax_wire.dequant_v6_pool(jnp.asarray(pool), jnp.asarray(offsets),
                                    samples)
    assert np.array_equal(_bits(got), _bits(want))
    fields = wire.v6_fields(torch.from_numpy(pool),
                            torch.from_numpy(offsets), samples)
    order = fields[1].numpy()
    assert {0, 1, 2, 3} <= set(order.tolist())
    assert np.isnan(got).any() and np.isinf(got).any()
    head = pool.view(np.uint8)[:hb]             # clip 0: random words
    widths = (head[2 * nb:4 * nb].view(np.uint16)[:, None]
              >> (2 + 3 * np.arange(4))) & 7
    assert (widths == 7).any() and (widths == 0).any()
    # the crafted clip: its order-3 recurrence leaves int32 (Python ints)
    r, order, coef, init1, init2 = (x.tolist() for x in fields[:5])
    lane = nb                                   # clip 1, block 0
    assert (order[lane], coef[lane], init1[lane], init2[lane]) == (
        3, 127, 127, -128)
    qp, qp2, peak = init1[lane], init2[lane], 0
    for t in range(128):
        qp, qp2 = r[lane][t] + ((coef[lane] * qp + 16) >> 5) - qp2, qp
        peak = max(peak, abs(qp))
    assert peak > 2 ** 31


def test_cpu_decodes_launch_no_kernel_and_build_nothing(monkeypatch):
    """On the CPU ``dequant_wire`` (every ADPCM width) and
    ``dequant_v6_pool`` run their plain versions: both kernel counters
    stay 0 and nothing is built.  A device that is neither the CPU nor
    CUDA is refused."""
    def no_build(name):
        raise AssertionError(f'built {name} on the CPU')

    monkeypatch.setattr(wire._build, 'load', no_build)
    monkeypatch.setattr(wire._adpcm_decode, 'launches', 0)
    monkeypatch.setattr(wire.dequant_v6_pool, 'launches', 0)
    samples = 16000
    for bits in (4, 3, 2):
        buf = _random_adpcm(bits, samples, 2, seed=20 + bits)
        assert wire.dequant_wire(torch.from_numpy(buf),
                                 samples).shape == (2, samples)
    rows = [audio_io.v6_encode_clip(c) for c in _v6_signals(samples)[:2]]
    pool, offsets = _v6_pool(rows)
    assert wire.dequant_v6_pool(torch.from_numpy(pool),
                                torch.from_numpy(offsets),
                                samples).shape == (3, samples)
    assert wire._adpcm_decode.launches == 0
    assert wire.dequant_v6_pool.launches == 0
    meta = torch.device('meta')
    with pytest.raises(ValueError, match='device'):
        wire.dequant_wire(torch.zeros(2, audio_io.adpcm_bytes(samples),
                                      dtype=torch.uint8, device=meta),
                          samples)
    with pytest.raises(ValueError, match='device'):
        wire.dequant_v6_pool(torch.zeros(100, dtype=torch.int32,
                                         device=meta),
                             torch.zeros(2, dtype=torch.int32, device=meta),
                             samples)


@pytest.mark.parametrize('samples', [80000, 96000, 160000])
def test_wire_widths_equal_sed_tpu(samples):
    widths = wire.wire_widths(samples)
    assert widths == jax_wire.wire_widths(samples)
    assert sorted(widths.values(), key=str) == sorted(
        [2, 3, 4, 5, 6, 'adpcm2', 'adpcm3', 'adpcm4'], key=str)


@pytest.mark.parametrize('samples', [257, 259])
def test_wire_widths_asserts_where_sed_tpu_does(samples):
    """At 257 samples the padded adpcm4 width is 257 itself, at 259 the
    adpcm3 width: ``sed_tpu``'s asserts fire there, and the port's too."""
    with pytest.raises(AssertionError):
        jax_wire.wire_widths(samples)
    with pytest.raises(AssertionError):
        wire.wire_widths(samples)


def test_dequant_wire_refuses_what_is_no_wire():
    buf = torch.zeros(2, 80000, dtype=torch.uint8)
    with pytest.raises(ValueError, match='samples'):
        wire.dequant_wire(buf)
    with pytest.raises(ValueError, match='neither'):
        wire.dequant_wire(buf[:, :40000], 80000)
    with pytest.raises(ValueError, match='dtype'):
        wire.dequant_wire(torch.zeros(2, 10, dtype=torch.float64))
    # mu-law at width == samples
    assert wire.dequant_wire(buf, 80000).shape == (2, 80000)


@pytest.fixture(scope='module')
def engines():
    cfg = AUDIO_16K
    ref = jax_engine.SedInferenceEngine(
        jax_get_model(MODEL, cfg), load_variables_npz(CKPT), cfg,
        sample_duration=5, overlap=True, batch_size=8)
    port = engine.SedInferenceEngine(load_npz(CKPT, MODEL, cfg, 'cpu'), cfg,
                                     'cpu', sample_duration=5, overlap=True,
                                     batch_size=8)
    return ref, port


@pytest.fixture(scope='module')
def clips():
    return make_clips(8, AUDIO_16K.sample_rate, seconds=5, seed=0)


@pytest.mark.parametrize('name', ['adpcm4', 'q6', 'mulaw'])
def test_predict_clips_on_wire_identical_to_sed_tpu(engines, clips, name):
    ref, port = engines
    buf = ENCODERS[name][0](clips)
    ev_ref, xml_ref = ref.predict_clips(buf)
    ev_port, xml_port = port.predict_clips(buf)
    assert sum(map(len, ev_ref)) > 0
    assert ev_port == ev_ref
    assert xml_port == xml_ref
    assert fused_logmel.launches == 0            # the CPU runs plain


@pytest.mark.parametrize('name', ['q2', 'q3', 'q4', 'q5', 'adpcm3',
                                  'adpcm2'])
def test_predict_clips_on_wire_equals_its_decoded_clips(engines, clips,
                                                        name):
    """Every other wire: the engine decodes it on the device into the
    framewise output of the same clips decoded on the host."""
    _, port = engines
    encode, decode_np = ENCODERS[name]
    buf = encode(clips[:4])
    decoded = decode_np(buf, port.window_samples)
    fw, cw = port.infer_framewise(buf)
    fw_dec, cw_dec = port.infer_framewise(decoded)
    assert np.array_equal(fw, fw_dec) and np.array_equal(cw, cw_dec)


def test_predict_clips_rejects_foreign_uint8_widths(engines):
    _, port = engines
    with pytest.raises(ValueError, match='80000'):
        port.predict_clips(np.zeros((2, 30000), np.uint8))
    # an int16 buffer at a wire's width is no wire
    width = jax_audio_io.adpcm_bytes(80000)
    with pytest.raises(ValueError, match='80000'):
        port.predict_clips(np.zeros((2, width), np.int16))


@pytest.fixture(scope='module')
def long_clips():
    return make_clips(3, AUDIO_16K.sample_rate, seconds=7, seed=5)


@pytest.mark.parametrize('name', ['q6', 'adpcm4'])
def test_windowed_on_wire_identical_to_sed_tpu(engines, long_clips, name):
    """``predict_clips_windowed`` takes a wire of the whole clips, as
    ``sed_tpu`` does: ``clip_samples`` names the decoded length, the clip
    is decoded on the device and the windows are cut from it."""
    ref, port = engines
    samples = long_clips.shape[1]
    buf = ENCODERS[name][0](long_clips)
    assert buf.dtype == np.uint8 and buf.shape[1] < samples
    names = ['a', 'b', 'c']
    ev_ref = ref.predict_clips_windowed(buf, names, duration=7.0, step=1,
                                        clip_samples=samples)
    ev_port = port.predict_clips_windowed(buf, names, duration=7.0, step=1,
                                          clip_samples=samples)
    assert sum(map(len, ev_ref)) > 0
    assert ev_port == ev_ref
    # and the wire gives what its decoded clips give
    decoded = ENCODERS[name][1](buf, samples)
    assert port.predict_clips_windowed(decoded, names, duration=7.0,
                                       step=1) == ev_port


def test_windowed_path_refuses_uint8(engines, long_clips):
    """... when ``clip_samples`` is missing: the width of a uint8 buffer
    cannot name its decoded length."""
    _, port = engines
    buf = jax_audio_io.adpcm_encode(long_clips)
    with pytest.raises(ValueError, match='samples'):
        port.predict_clips_windowed(buf, ['a', 'b', 'c'], duration=7.0,
                                    step=1)
