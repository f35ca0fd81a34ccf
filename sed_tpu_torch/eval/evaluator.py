"""Evaluator: model forward over a split + AP + segment-based metrics
(counterpart of ``sed_tpu/eval/evaluator.py``).

The forward runs under ``inference_mode`` on the evaluator's device, one
batch of the loader at a time.  ``sed_tpu`` pads the ragged last batch
to keep one jit entry; eval-mode BatchNorm works per sample, so here the
batch runs as it comes, and the outputs are the same rows.  AP comes
from ``eval/ap.py`` (numpy, sklearn's values) and the segment metrics
from ``eval/segment_metrics.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from sed_tpu_torch import config
from sed_tpu_torch.eval import ap as ap_metrics
from sed_tpu_torch.eval import segment_metrics
from sed_tpu_torch.post import events as post_events
from sed_tpu_torch.ops import wire as wire_ops
from sed_tpu_torch.serve.engine import check_device


@torch.inference_mode()
def forward_all(model: torch.nn.Module, loader, device,
                return_target: bool = True) -> dict:
    """Accumulate model outputs over a data loader into numpy arrays
    (``sed_tpu.eval.evaluator.forward_all``)."""
    out: dict = {}

    def _append(key, value):
        out.setdefault(key, []).append(value)

    for batch in loader:
        wav = wire_ops.dequant_wire(torch.from_numpy(
            np.ascontiguousarray(batch['waveform'])).to(device))
        res = model(wav)
        _append('audio_name', np.asarray(batch['audio_name']))
        _append('clipwise_output', res['clipwise_output'].cpu().numpy())
        _append('framewise_output', res['framewise_output'].cpu().numpy())
        if return_target and 'target' in batch:
            _append('target', batch['target'])
        if return_target and 'strong_target' in batch:
            _append('strong_target', batch['strong_target'])
    return {k: np.concatenate(v, axis=0) for k, v in out.items()}


class Evaluator:
    """AT + SED evaluation of a port model on ``device`` (the card unless
    the caller asks for the CPU).  A CUDA device that is absent, or TF32
    on, raises (as the engine): there is no fallback to the CPU.

    The forward runs the model in eval mode and gives it back in the mode
    it had, so a train loop that evaluates keeps training in training
    mode."""

    def __init__(self, model: torch.nn.Module, device='cuda',
                 sed_params: config.SedParams = config.EVAL_SED_PARAMS):
        self.device = check_device(device)
        self.model = model.to(self.device)
        self.sed_params = sed_params

    def forward(self, data_loader) -> dict:
        was_training = self.model.training
        self.model.eval()
        try:
            return forward_all(self.model, data_loader, self.device)
        finally:
            self.model.train(was_training)

    def evaluate(self, data_loader, reference_csv_path: str,
                 submission_path: str, frames_per_second: int):
        """Returns (statistics, output_dict): clipwise AP, framewise AP,
        and sed_eval-style segment metrics from decoded events."""
        output_dict = self.forward(data_loader)
        statistics = {}
        statistics['clipwise_ap'] = ap_metrics.clipwise_average_precision(
            output_dict['target'], output_dict['clipwise_output'],
            average=None)
        if 'strong_target' in output_dict:
            n = min(output_dict['strong_target'].shape[1],
                    output_dict['framewise_output'].shape[1])
            statistics['framewise_ap'] = ap_metrics.sed_average_precision(
                output_dict['strong_target'][:, :n],
                output_dict['framewise_output'][:, :n], average=None)

        predict_event_list = post_events.frame_prediction_to_event_prediction(
            output_dict, self.sed_params, frames_per_second)
        post_events.write_submission(predict_event_list, submission_path)
        statistics['sed_metrics'] = segment_metrics.official_evaluate(
            reference_csv_path, submission_path)
        return statistics, output_dict
