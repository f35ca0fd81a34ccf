"""Joint weak + strong training through ``train/step.make_train_step``.

Set-up builds one training step (the program's model holding the
benchmark's seeded tensors, its AMSGrad, the clip and frame BCE, mixup,
timeshift and SpecAugment on the card, int16 wire), feeds it through
``train/prefetch.device_prefetch`` from weak and strong pools drawn from
the seed, and drives it through its first ``checked_steps`` steps; the
window then runs the same object on.  The step's random draws come from
a card generator seeded from the run's seed.

End-to-end: ``train_clips_per_s``, the weak and strong clips the step
consumed in the window over the whole window.  Correctness: the plain
reference (``reference/plain.py``) retakes the first steps from the same
tensors, batches and generator state: each step's loss, every leaf's
first gradient as AMSGrad got it (its first moment after one step over
1 - b1) and every leaf's change after the checked steps, by the gap of
the norms at the worst leaf; the BatchNorm running statistics likewise.
With ``--trace 1`` a traced segment of ``traced_steps`` steps follows
the window.
"""

from __future__ import annotations

import time

import numpy as np

from bench_h100 import common, generate
from bench_h100.harness import Run
from bench_h100.reference import plain
from bench_h100.trace import Trace

B1 = 0.9
# what the step below and ``plain.augment`` apply, in this order
AUGMENTATION = 'specaugment_timeshift_mixup'


def _pools(ctx):
    tr, cfg = ctx.traffic, ctx.config
    sr = cfg['audio']['sample_rate']
    weak = generate.train_pool(tr['weak_pool'], sr, tr['clip_seconds'],
                               ctx.seed, cfg['classes'],
                               tr['events_per_clip'])
    strong = generate.train_pool(tr['strong_pool'], sr, tr['clip_seconds'],
                                 ctx.seed + 1000003, cfg['classes'],
                                 tr['events_per_clip'])
    return weak, strong


class Program:
    """The program's training step, fed as the window feeds it."""

    def __init__(self, ctx, tensors: dict, record: int):
        from sed_tpu_torch import losses
        from sed_tpu_torch.train.prefetch import device_prefetch
        from sed_tpu_torch.train.state import create_train_state
        from sed_tpu_torch.train.step import make_train_step
        import torch
        tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
        if tr['augmentation'] != AUGMENTATION:
            raise ValueError(f'augmentation {tr["augmentation"]}: the '
                             f'driver applies {AUGMENTATION} only')
        self.model = ctx.cell.reference.program_model(
            cfg, tensors, common.program_audio(cfg), dev)
        self.state = create_train_state(self.model, tr['lr'], fresh=False)
        self.step = make_train_step(
            self.model, self.state.optimizer, losses.clip_bce,
            losses.frame_bce, mixup=True, timeshift=True, spec_augment=True,
            wire_samples=tr['clip_seconds'] * cfg['audio']['sample_rate'])
        self.recorded = []
        weak, strong = _pools(ctx)

        def batches():
            for i, b in enumerate(generate.train_batches(
                    weak, strong, ctx.seed, tr['weak_batch'],
                    tr['strong_batch'])):
                if i < record:
                    self.recorded.append(b)
                yield b
        self.feed = device_prefetch(batches(), size=tr['prefetch'],
                                    device=dev)
        self.generator = torch.Generator(device=dev).manual_seed(ctx.seed)
        self.generator_state = self.generator.get_state()

    def __call__(self):
        weak, strong = next(self.feed)
        return self.step(weak, strong, self.generator)

    def close(self):
        self.feed.close()


def _norms(tensors: dict) -> dict:
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def first_steps(prog: Program, steps: int) -> dict:
    """Drive the program's first ``steps`` steps and read what the
    comparison needs: losses, first-gradient and change norms by leaf."""
    import torch
    params = dict(prog.model.named_parameters())
    init = {k: v.detach().clone() for k, v in prog.model.state_dict().items()}
    losses, grad1 = [], None
    for i in range(steps):
        losses.append(prog()['loss'].detach().clone())
        if i == 0:
            # what AMSGrad got: its first moment over 1 - b1 (none kept:
            # it got nothing)
            opt = prog.state.optimizer
            grad1 = _norms({k: opt.state[p].get('mu', torch.zeros_like(p))
                            / (1.0 - B1) for k, p in params.items()})
    state = prog.model.state_dict()
    change = _norms({k: state[k] - init[k] for k in init
                     if 'num_batches' not in k})
    return {'losses': [float(x) for x in losses], 'grad1': grad1,
            'change': change}


def run(ctx) -> Run:
    import torch
    from sed_tpu_torch.ops.logmel_kernel import fused_logmel
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    common.full_precision(ctx.config)
    tensors = ctx.cell.reference.weights(cfg, ctx.seed, dev,
                                         ctx.cell.spec['weights'])
    prog = Program(ctx, tensors, tr['checked_steps'])
    got = first_steps(prog, tr['checked_steps'])
    for _ in range(tr['extra_warm_steps']):
        prog()
    common.sync(dev)
    setup_s = time.perf_counter() - ctx.t_start

    clips_per_step = tr['weak_batch'] + tr['strong_batch']
    window = common.Window(ctx.seconds)
    losses, steps = [], 0
    while not window.done():
        losses.append(prog()['loss'])
        steps += 1
    common.sync(dev)
    wall = time.perf_counter() - window.t0
    finite = bool(torch.isfinite(torch.stack(losses)).all())
    ctx.log(f'window {wall:.3f} s: {steps} steps, setup {setup_s:.3f} s, '
            f'losses finite: {finite}')
    run = Run(attempted=steps, failed=0 if finite else steps,
              end_to_end={'train_clips_per_s': steps * clips_per_step / wall,
                          'setup_s': setup_s},
              checks=[], memory_peak_bytes=None,
              info={'kind': 'train', 'config': cfg,
                    'model': ctx.cell.reference, 'window_s': wall,
                    'steps': steps, 'clips_per_step': clips_per_step,
                    'mixed_rows_per_step': clips_per_step // 2,
                    'clip_samples': tr['clip_seconds']
                    * cfg['audio']['sample_rate']})
    if ctx.trace:
        n = tr['traced_steps']
        out = {}
        with common.profiled(dev, out):
            prog()
            common.sync(dev)
            launches = fused_logmel.launches
            with common.marker():
                for _ in range(n):
                    with common.span('step'):
                        prog()
                common.sync(dev)
            launches = fused_logmel.launches - launches
        run.trace = Trace(out['prof'])
        run.counters['fused_logmel.launches'] = launches
        run.info['traced_clips'] = n * clips_per_step
    run.memory_peak_bytes = common.peak_memory(dev)
    recorded, gen_state = prog.recorded, prog.generator_state
    prog.close()
    del prog
    common.free(dev)
    want = reference_steps(ctx, tensors, recorded, gen_state)
    run.checks = [(name, value, ctx.cell.spec['limits'][name])
                  for name, value in gaps(got, want).items()]
    return run


def reference_steps(ctx, tensors: dict, recorded: list, gen_state,
                    dtype=None, half: bool = False) -> dict:
    """The plain reference's first steps from ``tensors`` on the recorded
    batches, with the program's generator state (``dtype``: its compute
    dtype; ``half``: the fault of a step that leaves out the second half
    of each batch and takes the mean over the rest)."""
    import torch
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    dtype = dtype or torch.float32
    stats = {k: v.clone().to(dtype) for k, v in tensors.items()
             if 'running' in k}
    params = {k: v.clone().to(dtype).requires_grad_()
              for k, v in tensors.items() if 'running' not in k}
    init = {k: v.detach().clone() for k, v in params.items()}
    init_stats = {k: v.clone() for k, v in stats.items()}
    gen = torch.Generator(device=dev)
    gen.set_state(gen_state)
    every = dict(params, **stats)
    opt_state, losses, grad1 = {}, [], None

    def dev_t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)
    for t, (weak, strong) in enumerate(recorded, 1):
        total = 0.0
        for batch, key in ((weak, 'target'), (strong[0], 'strong_target')):
            if half:
                batch = {k: v[:len(v) // 2] for k, v in batch.items()}
            lam = dev_t(batch['mixup_lambda']).float()
            wav = dev_t(batch['waveform']).float() / 32767.0
            fw, cw = ctx.cell.reference.reference(
                every, wav, cfg, dtype=dtype, train=True, stats=stats,
                lam=lam, generator=gen)
            target = plain.mix(dev_t(batch[key]).float(), lam)
            if key == 'target':
                total = total + plain.bce(cw, target)
            else:
                n = min(fw.shape[1], target.shape[1])
                total = total + plain.bce(fw[:, :n], target[:, :n])
        grads = dict(zip(params, torch.autograd.grad(total,
                                                     list(params.values()))))
        losses.append(float(total.detach()))
        if t == 1:
            grad1 = _norms(grads)
        plain.amsgrad_({k: v.data for k, v in params.items()}, grads,
                       opt_state, t, lr=tr['lr'])
    change = _norms({k: params[k].detach() - init[k] for k in params})
    change.update(_norms({k: stats[k] - init_stats[k] for k in stats}))
    return {'losses': losses, 'grad1': grad1, 'change': change}


def gaps(got: dict, want: dict) -> dict:
    """The numbers compared.  ``loss_gap``: the largest relative loss
    difference over the steps.  ``grad_gap`` and ``change_gap``: at the
    worst parameter leaf, |program norm - reference norm| over the larger
    of the reference's norm of that leaf and of the median leaf; the
    change leaves exclude those whose reference gradient is under a
    thousandth of the median leaf's (they move by round-off alone).
    ``bn_gap``: the same over the BatchNorm running statistics' change."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got['losses'],
                                                   want['losses']))
    g_ref = want['grad1']
    g_med = float(np.median(list(g_ref.values())))

    def worst(keys, mine, ref):
        med = float(np.median([ref[k] for k in keys]))
        return max(abs(mine[k] - ref[k]) / max(ref[k], med) for k in keys)
    params = list(g_ref)
    moved = [k for k in params if g_ref[k] >= 1e-3 * g_med]
    buffers = [k for k in want['change'] if 'running' in k]
    return {'loss_gap': loss,
            'grad_gap': worst(params, got['grad1'], g_ref),
            'change_gap': worst(moved, got['change'], want['change']),
            'bn_gap': worst(buffers, got['change'], want['change'])}


def control(ctx) -> dict:
    """The readings that set the limits, for one seed at the cell's own
    size: the program's gaps against the float32 reference (a sound run),
    the control's (the reference in bfloat16 in the program's place) and
    the half-batch fault's (the reference with the fault, in its place)."""
    import torch
    tr, cfg, dev = ctx.traffic, ctx.config, ctx.device
    common.full_precision(ctx.config)
    tensors = ctx.cell.reference.weights(cfg, ctx.seed, dev,
                                         ctx.cell.spec['weights'])
    prog = Program(ctx, tensors, tr['checked_steps'])
    got = first_steps(prog, tr['checked_steps'])
    recorded, gen_state = prog.recorded, prog.generator_state
    prog.close()
    del prog
    common.free(dev)
    want = reference_steps(ctx, tensors, recorded, gen_state)
    low = reference_steps(ctx, tensors, recorded, gen_state, torch.bfloat16)
    half = reference_steps(ctx, tensors, recorded, gen_state, half=True)
    common.free(dev)
    out = {f'program.{k}': v for k, v in gaps(got, want).items()}
    ref = want['change']
    med = float(np.median([ref[k] for k in want['grad1']]))
    out['program.change_gap_leaf'] = max(
        want['grad1'],
        key=lambda k: abs(got['change'][k] - ref[k]) / max(ref[k], med))
    out.update({f'control.{k}': v for k, v in gaps(low, want).items()})
    out.update({f'fault_half_batch.{k}': v
                for k, v in gaps(half, want).items()})
    out['losses'] = want['losses']
    return out
