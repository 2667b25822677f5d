"""Jittered exponential backoff for checkpoint directory I/O (copy of
flexflow_tpu/runtime/retry.py).

Checkpoint saves and restores cross a filesystem that on clusters is often
network-attached (NFS, a bucket mount): transient `OSError`s there are
routine, and a recovery path that dies on the first flaky `os.replace`
defeats its own purpose. `with_retry` wraps exactly the small I/O criticals
(the commit rename, the meta.json read), never the device-to-host copy,
with a bounded, jittered exponential backoff.

The jitter source and the sleep function are injectable, so tests drive the
policy deterministically with a fake flaky filesystem.
"""

from __future__ import annotations

import random
import sys
import time
from dataclasses import dataclass
from typing import Callable, Tuple, Type


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff shape: delay_i = min(max_delay, base * 2**i) * (1 + U[0,jitter])."""

    attempts: int = 4
    base_delay_s: float = 0.05
    max_delay_s: float = 2.0
    jitter: float = 0.5
    retry_on: Tuple[Type[BaseException], ...] = (OSError,)

    def delay(self, attempt: int, rng: random.Random) -> float:
        raw = min(self.max_delay_s, self.base_delay_s * (2**attempt))
        return raw * (1.0 + self.jitter * rng.random())


DEFAULT_POLICY = RetryPolicy()


def with_retry(
    fn: Callable,
    *args,
    policy: RetryPolicy = DEFAULT_POLICY,
    rng: random.Random = None,
    sleep: Callable[[float], None] = None,
    description: str = "",
    on_retry: Callable[[int, BaseException], None] = None,
    **kwargs,
):
    """Call `fn(*args, **kwargs)`, retrying `policy.retry_on` exceptions up
    to `policy.attempts` attempts in all with jittered exponential backoff.
    The last attempt's exception propagates unwrapped, so callers keep
    their exact error type. `sleep` resolves to time.sleep at call time, so
    tests can fake it.

    `on_retry(attempt, exc)` fires before each backoff sleep (not on the
    last, propagating attempt). By default one stderr note names the
    description: a transient the backoff absorbs still leaves a trace, and
    the fault schedule's `ckpt_write` injections show in the log as the
    real flaky-filesystem events they rehearse."""
    if policy.attempts < 1:
        raise ValueError(f"a retry policy needs at least one attempt, got {policy.attempts}")
    rng = rng or random.Random()
    for attempt in range(policy.attempts):
        try:
            return fn(*args, **kwargs)
        except policy.retry_on as e:
            if attempt == policy.attempts - 1:
                raise
            if on_retry is not None:
                on_retry(attempt, e)
            else:
                print(
                    f"[flexflow_tpu_torch] transient {description or 'I/O'} "
                    f"failure (attempt {attempt + 1}/{policy.attempts}), "
                    f"retrying: {type(e).__name__}: {e}",
                    file=sys.stderr,
                )
            (sleep or time.sleep)(policy.delay(attempt, rng))


__all__ = ["RetryPolicy", "DEFAULT_POLICY", "with_retry"]
