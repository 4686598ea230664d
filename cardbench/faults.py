"""Faults planted under the timed path, each of which the check has to
catch: ``fault(engine)`` changes an engine after its warm-up and before
the window (``harness.serve_cell(faults=)``). The CPU tests plant them at
the smoke widths, ``control.py --faults`` at the cells' own size."""
from __future__ import annotations

import torch


def altered_token(engine):
    """Every fifth decoded token replaced by the next id, where the engine
    produces it."""
    decode, V = engine._decode_one, engine.cfg.vocab

    def _decode_one(i, req):
        decode(i, req)
        if len(req.generated) % 5 == 0:
            req.generated[-1] = (req.generated[-1] + 1) % V
    engine._decode_one = _decode_one


def state_unchanged(engine):
    """A decode step that leaves the lane's cache as it found it."""
    dec = engine.decoder
    step = dec.step

    def frozen(i, token, pos):
        with torch.inference_mode():
            keep = {n: t.clone() for n, t in dec.caches[i].items()}
            out = step(i, token, pos)
            for n, t in dec.caches[i].items():
                t.copy_(keep[n])
        return out
    dec.step = frozen


def wrong_lane(engine):
    """A swapped-out request's state restored into the lane after the one
    it is handed: it decodes on what its own lane held before."""
    dec, n = engine.decoder, engine.n_slots

    def _swap_in(i, req):
        dec.load((i + 1) % n, req.cache)
        req.cache = None
    engine._swap_in = _swap_in


def limit_frozen(engine):
    """The time limit's state left unchanged by completions: it stays at
    its initial value."""
    engine.adapter.record = lambda duration_ms, now: None


FAULTS = {f.__name__: f for f in (altered_token, state_unchanged, wrong_lane,
                                  limit_frozen)}
