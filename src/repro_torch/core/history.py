"""Round-history assembly (port of ``repro/core/history.py``).

``RoundRecorder`` builds every per-round record with the reference's
uniform schema — round, staleness, loss_first, loss_last, client_loss,
bytes_up, bytes_down, dropped, straggled, state_drops, plus any
``eval_fn`` metrics on rounds that evaluated — and converts device tensors
to plain Python once, at the end of the loop.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch


def json_scalar(v):
    """Tensor/NumPy metric -> plain Python: 0-d values become numbers,
    arrays become lists (by rank, not size)."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    a = np.asarray(v)
    return a.item() if a.ndim == 0 else a.tolist()


class RoundRecorder:
    """Collects raw (possibly device-backed) round records; one conversion
    to Python at the end."""

    def __init__(self, *, round_bytes: Optional[dict] = None,
                 burn_round_bytes: Optional[dict] = None):
        """``round_bytes`` / ``burn_round_bytes``: ``{"bytes_up",
        "bytes_down"}`` of the sampling and burn-in regimes."""
        self.round_bytes = round_bytes
        self.burn_round_bytes = burn_round_bytes
        self._raw: List[dict] = []

    def record(self, *, round_idx: int, metrics: dict, is_burn: bool = False,
               staleness: int = 0, dropped: int = 0, straggled: int = 0,
               state_drops=0, eval_metrics: Optional[dict] = None) -> dict:
        """Append one round's raw record (values may still be on device)
        and return it for live ``on_round`` consumers. ``staleness`` is the
        exponent of the round's discount (straggler lateness included),
        ``dropped`` counts the cohort's masked-out clients, ``straggled``
        its straggler lateness, ``state_drops`` the client-state writes the
        store's CAS dropped (an int, or a device scalar)."""
        bts = (self.burn_round_bytes if is_burn
               else self.round_bytes) or self.round_bytes
        rec = {"round": round_idx, "staleness": staleness,
               "metrics": metrics,
               "bytes_up": None if bts is None else bts["bytes_up"],
               "bytes_down": None if bts is None else bts["bytes_down"],
               "dropped": dropped, "straggled": straggled,
               "state_drops": state_drops}
        if eval_metrics is not None:
            rec["eval"] = eval_metrics
        self._raw.append(rec)
        return rec

    def history(self) -> List[dict]:
        """Finalize every record to JSON-safe Python in one pass."""
        history = []
        for rec in self._raw:
            entry = {"round": rec["round"], "staleness": rec["staleness"],
                     "loss_first": float(rec["metrics"]["loss_first"]),
                     "loss_last": float(rec["metrics"]["loss_last"])}
            entry["client_loss"] = entry["loss_last"]
            entry["bytes_up"] = (None if rec["bytes_up"] is None
                                 else json_scalar(rec["bytes_up"]))
            entry["bytes_down"] = (None if rec["bytes_down"] is None
                                   else json_scalar(rec["bytes_down"]))
            entry.update(dropped=int(rec["dropped"]),
                         straggled=rec["straggled"],
                         state_drops=int(json_scalar(rec["state_drops"])))
            entry.update({k: json_scalar(v)
                          for k, v in rec.get("eval", {}).items()})
            history.append(entry)
        return history
