"""Named spans of the port's phases for torch.profiler traces, and the
stream-ordered device time of the timed ones.

`span(name, device=None)` does nothing unless a profiler is active, so
the spans stay in the main path at no measurable cost. The switch is
torch's process-wide flag `torch.autograd.profiler._is_profiler_enabled`
(one attribute read), which every profiler sets, one that traces all
threads too; `torch.autograd._profiler_enabled()` is per thread and
reads False under such a profiler. Under a profiler:

- it enters a `torch.profiler.record_function(name)` range, which the
  trace holds as a `user_annotation` on the clock of the card's kernels
  and copies, so an idle gap of the card can be put down to the phase the
  host was in;
- where `device` is a CUDA device, it also records a timing CUDA event on
  that device's current stream at entry and at exit, on the calling
  thread. The pair brackets the phase's kernels in stream order even when
  the host runs ahead of the card (the backward's kernels, launched from
  autograd's own thread, lie between the events as long as the exit is
  recorded after `loss.backward()` returns).

`backward_span(name, x)` times, the same way, the backward of the work
between `x` and the tensor given to the `close` it returns: an identity
autograd node at each end records the entry event when the gradient of
the output arrives and the exit event once the gradient of `x` is done,
on the stream autograd runs them on. It records only under a profiler,
on a card, and where `x` takes a gradient (no exit is reached otherwise).

The event pairs go to a module-level table, as kernels/_build.LAUNCHES
counts launches: `device_ms()` gives {name: (total ms, count)} and
`reset()` clears it. Pairs whose exit the card has passed are folded into
the totals as new timed spans open (`Event.query`, never a wait), which
bounds the table over a profiled epoch.
"""
from __future__ import annotations

import collections
import contextlib
import threading

import torch
from torch.autograd import profiler as _profiler
from torch.profiler import record_function

_OFF = contextlib.nullcontext()
_LOCK = threading.Lock()
_PENDING: collections.deque = collections.deque()  # (name, start, end)
_TOTALS: dict = {}                                 # name -> [ms, count]


def span(name: str, device=None):
    """A context manager naming the phase `name` in an active profiler's
    trace, timed on the card where `device` is a CUDA device; a shared
    no-op without a profiler."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _span(name, device)


def _on_card(device) -> bool:
    return device is not None and torch.device(device).type == "cuda"


@contextlib.contextmanager
def _span(name: str, device):
    with record_function(name):
        if not _on_card(device):
            yield
            return
        stream = torch.cuda.current_stream(device)
        _fold(wait=False)
        start = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        yield
        end = torch.cuda.Event(enable_timing=True)
        end.record(stream)
        with _LOCK:
            _PENDING.append((name, start, end))


def _same(y):
    return y


def backward_span(name: str, x: torch.Tensor):
    """-> (x, close): time the backward of the work from `x` to the tensor
    that `close(y)` is given (close returns it) as the timed span `name`;
    without a profiler, off a card, or where `x` takes no gradient, `x`
    itself and an identity close."""
    if not (_profiler._is_profiler_enabled and torch.is_grad_enabled()
            and x.requires_grad and _on_card(x.device)):
        return x, _same
    pair = {}
    return (_BackwardMark.apply(x, name, pair, False),
            lambda y: _BackwardMark.apply(y, name, pair, True))


class _BackwardMark(torch.autograd.Function):
    """Identity; its backward records a timing CUDA event on the current
    stream: the entry at the output's end (it runs first), the exit at the
    input's end, which then puts the pair in the table."""

    @staticmethod
    def forward(ctx, x, name, pair, entry):
        ctx.name, ctx.pair, ctx.entry = name, pair, entry
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        if ctx.entry:
            _fold(wait=False)
        event = torch.cuda.Event(enable_timing=True)
        event.record(torch.cuda.current_stream(grad.device))
        if ctx.entry:
            ctx.pair["start"] = event
        elif "start" in ctx.pair:
            with _LOCK:
                _PENDING.append((ctx.name, ctx.pair.pop("start"), event))
        return grad, None, None, None


def _fold(wait: bool) -> None:
    """Fold pairs into the totals in the order they were recorded, up to
    the first the card has not passed yet (wait: wait for every one)."""
    with _LOCK:
        while _PENDING:
            name, start, end = _PENDING[0]
            if wait:
                end.synchronize()
            elif not end.query():
                return
            _PENDING.popleft()
            tot = _TOTALS.setdefault(name, [0.0, 0])
            tot[0] += start.elapsed_time(end)
            tot[1] += 1


def device_ms() -> dict:
    """{span name: (total device ms, count)} of the timed spans since the
    last reset(), waiting for those the card has not finished."""
    _fold(wait=True)
    with _LOCK:
        return {k: (ms, n) for k, (ms, n) in _TOTALS.items()}


def reset() -> None:
    with _LOCK:
        _PENDING.clear()
        _TOTALS.clear()
