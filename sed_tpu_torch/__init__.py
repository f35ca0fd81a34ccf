"""sed_tpu_torch — the PyTorch / CUDA port of ``sed_tpu``.

The JAX package ``sed_tpu`` is the reference; this package computes the
same functions with PyTorch on an NVIDIA GPU (or on the CPU through the
plain PyTorch versions of its kernels).  Its layout mirrors ``sed_tpu``:

config      audio configs, labels, event-decoding thresholds
dsp         log-mel frontend in plain PyTorch (the kernel's plain version)
            and the DFT / mel filter design; the gammatone filterbank
            (numpy design and packing, batched gammatonegram on tensors)
            and its plot CLI; the pseudo-CQT frontend; DFT / ISTFT /
            enframe transforms on tensors
ops         the hand-written CUDA log-mel kernel's wrapper; the device
            decode of every wire (int16, mu-law, qN, ADPCM, and the
            ragged v6 pool with its CUDA predictor kernel)
models      nn.Module model zoo, all of sed_tpu's registry names (CnnSed:
            CNN, + BiGRU, + MultiHead; the ESPnet Transformer / Conformer
            encoders and the Conformer, token-pooling, VGGish and CNN14
            models) on log-mel or packed gammatone features, train mode
            included; sed_tpu's initialisers
augment     SpecAugment, mixup and timeshift on tensors
losses      clip / frame BCE, on probabilities and on logits
train       optax-form AMSGrad, the joint train step (loss scaling),
            .pth checkpoint lineage, device prefetch
compat      flax variables / reference .pth -> PyTorch state_dict bridge;
            seeded weights on the bench checkpoint for the other models
serve       wav -> events -> XML serving engine (batched, pipelined
            stream, resident file passes, the ragged v6 pass, on-device
            windowed merging) and ``StreamingSed``
post        event decoding, overlap-add merging, XML
native      the g++-built host event decoder and ADPCM encoder (numpy
            fallbacks)
data        audio I/O and every wire codec, saver and file reader; label
            csvs, HDF5 packing, the
            HDF5 datasets, samplers and loaders; the AudioSet downloader
eval        Evaluator: forward over a split, AP and segment metrics
thresholds  the numpy threshold optimizer
utils       .npz checkpoints, workspace paths, statistics, logging,
            profiler traces and step timing
cli         ``features`` (packing), ``download``, ``predict`` (and
            ``--resident``, ``predict_asr``),
            ``main_strong`` (training and inference), ``main`` (weak-only
            training), ``optimize_thresholds`` and ``calculate_metrics``

It imports nothing of JAX and nothing of ``sed_tpu``: the numpy-only
host modules it needs are its own copies, laid out as in ``sed_tpu``.
Entry points run on the card (``cuda``) unless the caller asks for the
CPU.
"""

__version__ = "0.1.0"
