"""CUDA start-up guard for entry scripts.

A card can fail in two ways at first use: raise (no CUDA runtime, no
device, a CUDA error at context creation) or HANG (a wedged card, so that
the first allocation never returns).  ``ensure_backend`` handles
both, so every example and command-line entry point does not re-grow its
own partial version:

* ``FDT_FORCE_CPU=1``: the caller asks for the CPU; nothing is probed.
* start-up raises: :class:`BackendUnavailable`, naming the error.  There
  is no fallback to the CPU: a run the caller meant for the card does not
  carry on silently without it.
* start-up hangs past the timeout (``FDT_DEVICE_TIMEOUT``, 300 s): the
  process exits 1 with a message recommending ``FDT_FORCE_CPU=1``.

Unlike the JAX package's guard, which falls back to the CPU when start-up
raises, this one refuses.  ``backend_fallback_reason`` keeps its name for
``doctor``, which reports the recorded error instead of exiting
(``ensure_backend(record_only=True)``).
"""

from __future__ import annotations

import os
import sys
import threading

__all__ = ["ensure_backend", "backend_fallback_reason", "force_cpu",
           "BackendUnavailable"]

#: Why CUDA start-up failed, recorded by ``ensure_backend(record_only=True)``
#: (``doctor`` FAILs its device check on it); None otherwise, including
#: under ``FDT_FORCE_CPU`` (a requested CPU is not a failure).
_fallback_reason: str | None = None


class BackendUnavailable(RuntimeError):
    """CUDA start-up failed and the caller did not ask for the CPU."""


def backend_fallback_reason() -> str | None:
    """The recorded CUDA start-up error, or None."""
    return _fallback_reason


def force_cpu() -> bool:
    """Whether the caller asked for the CPU (``FDT_FORCE_CPU`` set)."""
    return bool(os.environ.get("FDT_FORCE_CPU"))


def _probe() -> str:
    """Starts CUDA: ``torch.cuda.is_available()``, then one small
    allocation on the card.  Returns the card's name; raises on failure."""
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false (no usable "
                           "CUDA device)")
    torch.ones(1, device="cuda").add_(1)
    torch.cuda.synchronize()
    return torch.cuda.get_device_name(0)


def ensure_backend(timeout_s: float | None = None, *,
                   record_only: bool = False) -> None:
    """Starts CUDA or stops the caller (module docstring).

    ``timeout_s`` defaults to ``FDT_DEVICE_TIMEOUT`` (300 s).  With
    ``record_only`` a start-up error is recorded for
    :func:`backend_fallback_reason` instead of raised; a hang exits
    either way."""
    global _fallback_reason
    _fallback_reason = None
    if force_cpu():
        return
    if timeout_s is None:
        timeout_s = float(os.environ.get("FDT_DEVICE_TIMEOUT", "300"))

    box: dict = {}

    def probe():
        try:
            box["device"] = _probe()
        except Exception as e:  # any start-up failure is reported
            box["error"] = e

    th = threading.Thread(target=probe, daemon=True)
    th.start()
    th.join(timeout_s)
    if th.is_alive():
        print(f"FATAL: CUDA start-up did not return within {timeout_s:.0f}s "
              "(card hung?).  Re-run with FDT_FORCE_CPU=1 to use "
              "the CPU, or FDT_DEVICE_TIMEOUT=<s> to wait longer.",
              file=sys.stderr, flush=True)
        os._exit(1)
    if "error" in box:
        reason = repr(box["error"])
        if record_only:
            _fallback_reason = reason
            return
        raise BackendUnavailable(
            f"CUDA start-up failed: {reason}; set FDT_FORCE_CPU=1 to run "
            "on the CPU")
