"""Spans around the calls into the port's layers, recorded from the
benchmark's side in traced runs only.

A span is named in a metric reader's `SPANS` as `{"name": "module:attr"}`
(`attr` may be `Class.method`). `install` replaces each attribute with a
wrapper that runs the original inside `torch.profiler.record_function`
under the name "pb/<name>", and where a reader's `CAPTURE` names a
function for the span, keeps what that function takes from the call's
arguments. The port looks these attributes up at each call, so the
wrappers see every call the entry makes. `restore` puts the originals back.
"""
from __future__ import annotations

import functools
import importlib

from .trace import SPAN_PREFIX


def _owner(target: str):
    mod, attr = target.split(":")
    owner = importlib.import_module(mod)
    *path, last = attr.split(".")
    for p in path:
        owner = getattr(owner, p)
    return owner, last


class Spans:
    def __init__(self, spans: dict, capture: dict):
        from torch.profiler import record_function
        self.captured = {name: [] for name in capture}
        self._saved = []
        for name, target in spans.items():
            owner, attr = _owner(target)
            orig = owner.__dict__[attr] if isinstance(owner, type) \
                else getattr(owner, attr)
            keep = capture.get(name)
            sink = self.captured.get(name)

            def wrapper(*a, _orig=orig, _label=SPAN_PREFIX + name,
                        _keep=keep, _sink=sink, **k):
                if _keep is not None:
                    try:
                        _sink.append(_keep(a, k))
                    except Exception:   # the reader then reads nothing;
                        _sink.append(None)  # the call itself must go on
                with record_function(_label):
                    return _orig(*a, **k)

            # the port's own attributes on the function (launch counters
            # that it bumps through its module's name) go with it
            functools.update_wrapper(wrapper, orig)
            self._saved.append((owner, attr, orig))
            setattr(owner, attr, wrapper)

    def restore(self) -> None:
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        self._saved = []
