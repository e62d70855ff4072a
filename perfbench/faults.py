"""Faults planted in the program, to show that the comparison catches
them: each is a context manager that breaks the timed path underneath
the harness and restores it on exit.

* ``state_unchanged``: the optimizer returns the parameters and its
  state as they were, so a step leaves the train state unchanged;
* ``half_batch``: the loss leaves out half of the batch (half of the
  rows; of a one-row batch, half of the positions) and takes the mean
  over the rest.

A training cell on one chip has no exchange between chips and produces
no tokens, so those two faults are the ones it can have.

Faults in one family's mixer backward, which show what the comparison
sees of it (:data:`MIXER_FAULTS`, by reference family): the SSD scan's
backward (the plain scan that ``repro_torch::ssd_scan`` differentiates)
with

* ``ssd_grad_scaled``: every input gradient doubled;
* ``ssd_grad_no_decay``: no gradient to the log-decay (``A_log`` and
  that part of ``dt``);
* ``ssd_grad_no_bc``: no gradient to B and C.

Each keeps the scan's value and changes its gradient alone.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def state_unchanged():
    from repro_torch.train import optim
    orig = optim.optimizer_update

    def unchanged(grads, state, params, run, lr=3e-4, inplace=False):
        return params, state

    optim.optimizer_update = unchanged
    try:
        yield
    finally:
        optim.optimizer_update = orig


@contextlib.contextmanager
def half_batch():
    from repro_torch.models import api
    orig = api.lm_loss

    def half(logits, targets, vocab=None, aux=None):
        if logits.shape[0] > 1:
            n = logits.shape[0] // 2
            return orig(logits[:n], targets[:n], vocab, aux)
        n = logits.shape[1] // 2
        return orig(logits[:, :n], targets[:, :n], vocab, aux)

    api.lm_loss = half
    try:
        yield
    finally:
        api.lm_loss = orig


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch}


@contextlib.contextmanager
def _ssd_backward(wrong):
    """``wrong(plain, xh, a, B, C, chunk)`` in place of the plain scan
    that the op's backward differentiates (and that its CPU forward
    runs)."""
    from repro_torch.kernels.ssd_scan import ops
    orig = ops._plain

    def patched(xh, a, B_, C_, chunk):
        return wrong(orig, xh, a, B_, C_, chunk)

    ops._plain = patched
    try:
        yield
    finally:
        ops._plain = orig


def ssd_grad_scaled():
    def wrong(plain, xh, a, B_, C_, chunk):
        y = plain(xh, a, B_, C_, chunk)
        return y + (y - y.detach())
    return _ssd_backward(wrong)


def ssd_grad_no_decay():
    def wrong(plain, xh, a, B_, C_, chunk):
        return plain(xh, a.detach(), B_, C_, chunk)
    return _ssd_backward(wrong)


def ssd_grad_no_bc():
    def wrong(plain, xh, a, B_, C_, chunk):
        return plain(xh, a, B_.detach(), C_.detach(), chunk)
    return _ssd_backward(wrong)


MIXER_FAULTS = {"mamba2": {"ssd_grad_scaled": ssd_grad_scaled,
                           "ssd_grad_no_decay": ssd_grad_no_decay,
                           "ssd_grad_no_bc": ssd_grad_no_bc}}


def of_family(family: str) -> dict:
    """Every fault a cell of ``family`` can have planted."""
    return {**FAULTS, **MIXER_FAULTS.get(family, {})}
