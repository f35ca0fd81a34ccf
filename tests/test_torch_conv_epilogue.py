"""sed_tpu_torch/ops/conv_epilogue.py and the ConvBlock dispatch to it, on
the CPU (no card, no nvcc; the kernel itself is held to the plain version
in ``tests/test_torch_cuda.py``).

The plain epilogue must be the ops a ConvBlock ran before the kernel,
bit for bit.  The dispatch is observed through ``conv_epilogue.launches``
with the wrapper stubbed by a counting plain version; the wrapper itself
sends a CPU tensor to the plain version without a launch.  The
kernel's arithmetic (scale and shift per channel, one FMA, ReLU, the
pool's sum in avg_pool2d's order) is emulated in numpy and held to the
plain version within the card test's tolerance.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from sed_tpu_torch import config
from sed_tpu_torch.models import blocks
from sed_tpu_torch.models.zoo import CnnSed
from sed_tpu_torch.ops import conv_epilogue as ce

# the relative error the card tests allow the kernel against the plain
# version: max |kernel - plain| over max |plain|
REL_TOL = 1e-6


def _bn(channels: int, seed: int) -> blocks.BatchNorm:
    """An eval-mode BatchNorm with statistics and affine parameters of
    trained magnitudes."""
    rng = np.random.RandomState(seed)
    bn = blocks.BatchNorm(channels).eval()
    with torch.no_grad():
        bn.running_mean.copy_(torch.from_numpy(
            rng.uniform(-1.0, 1.0, channels).astype(np.float32)))
        bn.running_var.copy_(torch.from_numpy(
            rng.uniform(0.01, 4.0, channels).astype(np.float32)))
        bn.weight.copy_(torch.from_numpy(
            rng.uniform(0.2, 2.0, channels).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(
            rng.uniform(-1.0, 1.0, channels).astype(np.float32)))
    return bn


def _stats(bn):
    return (bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps)


def _x(batch, channels, frames, mels, seed):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(rng.standard_normal(
        (batch, channels, frames, mels)).astype(np.float32) * 2.0)


SHAPES = pytest.mark.parametrize('frames', [501, 601, 1001, 125, 62])
MELS = pytest.mark.parametrize('mels', [64, 32, 16, 8])


@SHAPES
@MELS
@pytest.mark.parametrize('pool', [(1, 1), (2, 2)])
def test_plain_epilogue_is_the_block_ops_bitwise(frames, mels, pool):
    bn = _bn(3, seed=frames + mels)
    x = _x(2, 3, frames, mels, seed=frames * mels)
    with torch.no_grad():
        want = F.relu(bn(x))
        if pool != (1, 1):
            want = F.avg_pool2d(want, pool)
        got = ce.conv_epilogue_plain(x, *_stats(bn), pool)
        wrapped = ce.conv_epilogue(x, *_stats(bn), pool)   # a CPU tensor
        dispatched = blocks.epilogue(x, bn, pool)
    assert got.shape == (2, 3, frames // pool[0], mels // pool[1])
    for out in (got, wrapped, dispatched):
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))


def _kernel_emulation(x: np.ndarray, mean, var, weight, bias, eps, pool):
    """``csrc/conv_epilogue.cu``'s arithmetic in numpy: the channel's
    scale and shift each correctly rounded in float32, one fused
    multiply-add an element (exact product and sum in float64, rounded
    once), ReLU, and the 2x2 sum from 0 in avg_pool2d's order, / 4."""
    f32 = np.float32
    invstd = f32(1.0) / np.sqrt(var + f32(eps))
    scale = (invstd * weight).astype(f32)
    shift = (bias - mean * scale).astype(f32)
    y = (x.astype(np.float64) * scale[:, None, None].astype(np.float64)
         + shift[:, None, None].astype(np.float64)).astype(f32)
    y = np.maximum(y, f32(0.0))
    if pool == (1, 1):
        return y
    h, w = y.shape[-2] // 2 * 2, y.shape[-1] // 2 * 2
    s = f32(0.0) + y[..., 0:h:2, 0:w:2]
    s = s + y[..., 0:h:2, 1:w:2]
    s = s + y[..., 1:h:2, 0:w:2]
    s = s + y[..., 1:h:2, 1:w:2]
    return s / f32(4.0)


@pytest.mark.parametrize('frames,mels,channels', [
    (501, 64, 64), (250, 32, 128), (125, 16, 256), (62, 8, 512),
    (601, 64, 64), (1001, 64, 64), (75, 8, 512)])
@pytest.mark.parametrize('pool', [(1, 1), (2, 2)])
def test_kernel_arithmetic_within_the_card_tolerance(frames, mels, channels,
                                                     pool):
    """The scale-and-shift form differs from the plain BatchNorm by an
    ulp or so: far inside the card tests' REL_TOL at the stack's shapes."""
    bn = _bn(channels, seed=channels)
    x = _x(1, channels, frames, mels, seed=frames)
    with torch.no_grad():
        want = ce.conv_epilogue_plain(x, *_stats(bn), pool).numpy()
    got = _kernel_emulation(x[0].numpy(), *(t.detach().numpy() for t in
                                            _stats(bn)[:4]), bn.eps, pool)
    err = np.abs(got - want[0]).max() / np.abs(want).max()
    assert err <= REL_TOL / 4, err


def test_wrapper_refuses_what_it_does_not_take():
    bn = _bn(4, seed=0)
    x = _x(1, 4, 9, 8, seed=0)
    with pytest.raises(ValueError, match=r'\(1, 1\) or \(2, 2\)'):
        ce.conv_epilogue(x, *_stats(bn), (3, 3))
    with pytest.raises(ValueError, match='unsupported device'):
        ce.conv_epilogue(x.to('meta'), *_stats(bn), (2, 2))


def _no_launch(*args):
    raise AssertionError('the kernel was launched for a CPU tensor')


@pytest.fixture
def stubbed_kernel(monkeypatch):
    """The wrapper, which a card tensor would take to the kernel, is the
    plain version and counts every call as a launch."""
    kernel = ce.conv_epilogue

    def launch(x, mean, var, weight, bias, eps, pool):
        kernel.launches += 1
        return ce.conv_epilogue_plain(x, mean, var, weight, bias, eps, pool)

    monkeypatch.setattr(ce, 'conv_epilogue', launch)
    monkeypatch.setattr(kernel, 'launches', 0)
    return kernel


def _block(seed=0):
    torch.manual_seed(seed)
    block = blocks.ConvBlock(2, 6)
    block.bn1.load_state_dict(_bn(6, seed + 1).state_dict())
    block.bn2.load_state_dict(_bn(6, seed + 2).state_dict())
    return block.eval()


def _unfused(block, x, pool_size, pool_type):
    y = F.relu(block.bn1(block.conv1(x)))
    y = F.relu(block.bn2(block.conv2(y)))
    if pool_size == (1, 1):
        return y
    if pool_type == 'avg':
        return F.avg_pool2d(y, pool_size)
    if pool_type == 'max':
        return F.max_pool2d(y, pool_size)
    return F.avg_pool2d(y, pool_size) + F.max_pool2d(y, pool_size)


@pytest.mark.parametrize('pool_size,pool_type', [
    ((2, 2), 'avg'), ((1, 1), 'avg'), ((1, 1), 'max'), ((2, 2), 'max'),
    ((2, 2), 'avg+max'), ((4, 2), 'avg')])
def test_conv_block_dispatch_by_pool(stubbed_kernel, monkeypatch, pool_size,
                                     pool_type):
    """Both epilogues of an eval block take the wrapper whatever the
    pool; only a (2, 2) 'avg' pool runs inside the second."""
    block = _block()
    x = _x(2, 2, 21, 16, seed=3)
    pools, stub = [], ce.conv_epilogue
    monkeypatch.setattr(ce, 'conv_epilogue', lambda x, *args: (
        pools.append(args[-1]), stub(x, *args))[1])
    with torch.inference_mode():
        got = block(x, pool_size=pool_size, pool_type=pool_type)
        want = _unfused(block, x, pool_size, pool_type)
    fused = pool_size == (2, 2) and pool_type == 'avg'
    assert stubbed_kernel.launches == 2
    assert pools == [(1, 1), pool_size if fused else (1, 1)]
    assert torch.equal(got, want)


def test_conv_block_dispatch_bypasses_training_cpu_and_autograd(
        stubbed_kernel, monkeypatch):
    block = _block()
    x = _x(2, 2, 21, 16, seed=4)
    # autograd in eval: the parameters want gradients
    out = block(x)
    assert out.requires_grad and stubbed_kernel.launches == 0
    out.sum().backward()
    assert block.conv1.weight.grad is not None
    # an input that wants a gradient, the parameters frozen
    block.requires_grad_(False)
    xg = x.clone().requires_grad_(True)
    block(xg).sum().backward()
    assert xg.grad is not None and stubbed_kernel.launches == 0
    # no gradient wanted: the kernel
    block(x)
    assert stubbed_kernel.launches == 2
    # training mode: batch statistics
    block.train()
    with torch.no_grad():
        block(x)
    assert stubbed_kernel.launches == 2
    # CPU tensors: the wrapper runs the plain ops, no launch
    block.eval()
    monkeypatch.setattr(ce, 'conv_epilogue', stubbed_kernel)
    monkeypatch.setattr(ce._build, 'launch', _no_launch)
    with torch.no_grad():
        got = block(x)
        want = _unfused(block, x, (2, 2), 'avg')
    assert stubbed_kernel.launches == 2
    assert torch.equal(got, want)


def test_four_block_stack_launches_eight_in_eval_none_in_training(
        stubbed_kernel, monkeypatch):
    """A narrow CnnSed: an eval forward takes the kernel for each of its 8
    convolutions and gives the forward's output without it (a CPU tensor
    in the wrapper); a training step takes none."""
    torch.manual_seed(0)
    model = CnnSed(config.AUDIO_16K, conv_channels=(8, 16, 16, 32),
                   temporal='gru', head='att', gru_hidden=16).eval()
    wav = torch.from_numpy(np.random.RandomState(5).uniform(
        -0.5, 0.5, (2, 16000)).astype(np.float32))
    with torch.inference_mode():
        got = model(wav)['framewise_output']
    assert stubbed_kernel.launches == 8
    stub = ce.conv_epilogue
    monkeypatch.setattr(ce, 'conv_epilogue', stubbed_kernel)
    monkeypatch.setattr(ce._build, 'launch', _no_launch)
    with torch.inference_mode():
        want = model(wav)['framewise_output']
    assert stubbed_kernel.launches == 8
    assert torch.equal(got, want)
    monkeypatch.setattr(ce, 'conv_epilogue', stub)
    model.train()
    out = model(wav, spec_augment=False)['clipwise_output']
    out.sum().backward()
    assert stubbed_kernel.launches == 8
