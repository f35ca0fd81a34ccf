"""What the drivers share: the program's audio configuration and serving
engine, timing helpers, and the profiler around a traced segment."""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np


def program_audio(config: dict):
    """The program's ``AudioConfig`` of a configuration's audio."""
    from sed_tpu_torch.config import AudioConfig
    a = config['audio']
    return AudioConfig(name=f'{a["sample_rate"] // 1000}k',
                       sample_rate=a['sample_rate'],
                       window_size=a['window_size'], hop_size=a['hop_size'],
                       mel_bins=a['mel_bins'], fmin=a['fmin'], fmax=a['fmax'],
                       ref=a['ref'], amin=a['amin'])


def engine(ctx, tensors: dict):
    """The program's serving engine on the cell's model holding
    ``tensors``, at the traffic's batch size."""
    from sed_tpu_torch.serve.engine import SedInferenceEngine
    cfg = program_audio(ctx.config)
    model = ctx.cell.reference.program_model(ctx.config, tensors, cfg,
                                             ctx.device)
    return SedInferenceEngine(model, cfg, ctx.device,
                              batch_size=ctx.traffic['batch_size'])


def full_precision(config: dict) -> None:
    """float32 products in full precision (no TF32), on both sides: the
    one precision the drivers run, which the configuration must state."""
    import torch
    if config['precision'] != 'float32' or config['tf32']:
        raise ValueError(f'{config["name"]}: precision '
                         f'{config["precision"]}, tf32 {config["tf32"]}; '
                         'the drivers run float32 without TF32 only')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def sync(device) -> None:
    import torch
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def p95(values) -> float:
    return float(np.percentile(np.asarray(values, np.float64), 95))


def sample(n: int, k: int, seed: int, salt: int) -> list:
    """``k`` of ``range(n)`` drawn from the seed, sorted."""
    rng = np.random.RandomState((int(seed) ^ salt) % (2 ** 32))
    return sorted(rng.choice(n, min(k, n), replace=False).tolist())


def peak_memory(device):
    import torch
    if device.type != 'cuda':
        return None
    sync(device)
    return int(torch.cuda.max_memory_allocated(device))


def free(device) -> None:
    import torch
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()


@contextlib.contextmanager
def profiled(device, out: dict):
    """Profile the block (host and device activity); ``out['prof']`` is
    the profiler.  The block marks its measured part with ``marker()``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == 'cuda':
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
        sync(device)
    out['prof'] = prof


def marker():
    from torch.profiler import record_function
    from bench_h100.trace import MARKER
    return record_function(MARKER)


def span(name: str):
    """A benchmark span around a call into a layer (profiled runs)."""
    from torch.profiler import record_function
    return record_function(f'bench::{name}')


def hook_spans(module, name: str) -> list:
    """A ``bench::<name>`` span around every forward of ``module``
    (removable handles)."""
    from torch.autograd.profiler import record_function
    stack = []

    def pre(_m, _inp):
        stack.append(record_function(f'bench::{name}').__enter__())

    def post(_m, _inp, _out):
        stack.pop().__exit__(None, None, None)
    return [module.register_forward_pre_hook(pre),
            module.register_forward_hook(post)]


class Window:
    """Host-clock window: ``done()`` once the deadline has passed."""

    def __init__(self, seconds: float):
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + seconds

    def done(self) -> bool:
        return time.perf_counter() >= self.deadline


class Capture:
    """A forward hook on the program's model that keeps the framewise
    output of the requests whose number is in ``which``, as the timed
    path produced it (a copy on the card)."""

    def __init__(self, model, which):
        self.which, self.now, self.kept = set(which), None, {}
        self.handle = model.register_forward_hook(self._hook)

    def _hook(self, _module, _inputs, out):
        if self.now in self.which:
            self.kept.setdefault(self.now, []).append(
                out['framewise_output'].detach().clone())

    def framewise(self, k):
        import torch
        return torch.cat(self.kept[k])

    def close(self):
        self.handle.remove()
