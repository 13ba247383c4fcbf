"""Faults planted under the timed path, for the check's own tests and for
the readings of its upper limits (``readings.py``): each wraps the
program's step (or answer) so that the rest of a run goes on unchanged."""
from __future__ import annotations

import torch


def state_unchanged(step):
    """A step that computes its loss and returns the state as it was."""
    def broken(params, opt_state, sparse_state, batch):
        loss, _, _ = step.loss_and_grads(params, batch)
        return params, opt_state, sparse_state, {"loss": loss,
                                                 "grad_norm": loss * 0 + 1}
    broken.loss_and_grads = step.loss_and_grads
    return broken


def half_batch(step):
    """A step that leaves out the second half of the batch's rows: its
    mean is taken over the rest."""
    def half(batch):
        return {k: v[: max(1, v.shape[0] // 2)] for k, v in batch.items()}

    def broken(params, opt_state, sparse_state, batch):
        return step(params, opt_state, sparse_state, half(batch))
    broken.loss_and_grads = lambda params, batch: step.loss_and_grads(
        params, half(batch))
    return broken


TRAIN_FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch}


def token_altered(generate):
    """A ``generate`` whose first new token is changed where it is
    produced (the next id of the vocabulary)."""
    def broken(params, cfg, prompt, n_new, **kw):
        out = generate(params, cfg, prompt, n_new, **kw)
        s = prompt.shape[1]
        out[:, s] = (out[:, s] + 1) % cfg.vocab
        return out
    return broken


def rows_left_out(generate):
    """A ``generate`` that serves the first half of the batch's prompts
    and answers the rest with those rows' tokens."""
    def broken(params, cfg, prompt, n_new, **kw):
        half = max(1, prompt.shape[0] // 2)
        out = generate(params, cfg, prompt[:half], n_new, **kw)
        rows = torch.arange(prompt.shape[0], device=out.device) % half
        return torch.cat([prompt, out[rows, prompt.shape[1]:]], dim=1)
    return broken


PREFILL_FAULTS = {"token_altered": token_altered,
                  "rows_left_out": rows_left_out}
