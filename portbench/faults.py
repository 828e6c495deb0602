"""Faults planted in the program, to show that the check catches them.

Each function plants one fault in the port's modules with
``monkeypatch.setattr``-style ``setattr(obj, name, value)`` (a pytest
``monkeypatch``, or ``Plant`` below, which undoes nothing: a process
that plants one serves only faulty runs). ``control.py --fault <name>``
reads a fault on the card at a cell's own size; the tests plant them on
the CPU. Plant a fault before the cell's system is built: the entries
take the extractor's forward when they build.
"""

from __future__ import annotations

import torch


class Plant:
    """``setattr`` with pytest's ``monkeypatch`` signature."""

    @staticmethod
    def setattr(obj, name, value):
        setattr(obj, name, value)


def unchanged(mp):
    """Every matcher layer returns its state unchanged."""
    from lightglue_tpu_torch.models import lightglue as lg
    mp.setattr(lg, "transformer_layer", lambda p, d0, d1, *a, **k: (d0, d1))


def half(mp, lost: bool = False):
    """Half of each batch left out: its other half answered with the first
    pair's answer, or (``lost``) with none (a batch of one: its answer
    lost)."""
    from lightglue_tpu_torch.models import lightglue as lg
    real = lg.forward_slots

    def fault(*a, **k):
        outs = real(*a, **k)
        out = outs[0]
        h = max(out.matches0.shape[0] // 2, 1)
        m0, ms0 = out.matches0.clone(), out.matching_scores0.clone()
        m0[h:] = m0[:1]
        ms0[h:] = ms0[:1]
        if lost:
            m0[h:], ms0[h:] = -1, 0.0
        if out.matches0.shape[0] == 1:
            m0[:], ms0[:] = -1, 0.0
        return [out._replace(matches0=m0, matching_scores0=ms0)] + outs[1:]
    mp.setattr(lg, "forward_slots", fault)


def altered(mp, bucket: int = None):
    """Every match moved to the next point of image 1 where it is produced
    (``bucket``: only in batches padded to that many points)."""
    from lightglue_tpu_torch.models import lightglue as lg
    real = lg._assign_and_filter

    def fault(la, conf, desc0, desc1, mask0, mask1):
        m0, m1, ms0, ms1 = real(la, conf, desc0, desc1, mask0, mask1)
        n = desc1.shape[1]
        if bucket is None or max(desc0.shape[1], n) == bucket:
            m0 = torch.where(m0 >= 0, (m0 + 1) % n, m0)
        return m0, m1, ms0, ms1
    mp.setattr(lg, "_assign_and_filter", fault)


def stop_first(mp):
    """The adaptive loop stops after its first layer."""
    from lightglue_tpu_torch.models import lightglue as lg
    mp.setattr(lg, "pooled_stop", lambda conf, counts: True)


def stop_never(mp):
    """The adaptive loop never stops early."""
    from lightglue_tpu_torch.models import lightglue as lg
    mp.setattr(lg, "pooled_stop", lambda conf, counts: False)


def moved(mp):
    """Every keypoint moved 3 px where the extractor produces it."""
    from lightglue_tpu_torch.models import superpoint
    real = superpoint.forward

    def fault(*a, **k):
        f = real(*a, **k)
        return f._replace(keypoints=f.keypoints + 3.0)
    mp.setattr(superpoint, "forward", fault)


def lost(mp):
    """Half of each batch left out, its answers lost."""
    half(mp, lost=True)


FAULTS = {"unchanged": unchanged, "half": half, "lost": lost,
          "altered": altered, "stop_first": stop_first,
          "stop_never": stop_never, "moved": moved}
