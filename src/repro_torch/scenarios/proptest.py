"""Property-based test driver with a graceful `hypothesis` fallback.

The tier-1 suite states invariants as properties (`@given` over strategies).
`hypothesis` is a *declared* dev dependency (requirements-dev.txt) and CI
installs it, but the runtime container may not ship it — and the suite must
still collect and exercise the invariants there.  This module re-exports the
real `given`/`settings`/`strategies` when hypothesis is importable and
otherwise substitutes a small deterministic driver:

  * each strategy is a value generator drawing from a seeded
    ``random.Random``;
  * ``@given`` runs ``max_examples`` examples (from ``@settings``, default
    50), with the RNG seeded from the test's qualified name and the example
    index — fully deterministic across runs and machines;
  * a failing example re-raises the original assertion augmented with the
    drawn arguments, so failures are reproducible by eye.

The fallback intentionally implements only the API surface this repo uses:
``st.integers``, ``st.floats``, ``st.booleans``, ``st.lists``, ``st.tuples``,
``st.sampled_from``, ``st.just``, plus ``given``/``settings``/``HAVE_HYPOTHESIS``.
No shrinking, no example database — CI (with real hypothesis) covers that.
"""
from __future__ import annotations

import random
from typing import Any, Callable, Iterable, List, Sequence

__all__ = ["given", "settings", "st", "HAVE_HYPOTHESIS"]

try:  # pragma: no cover - exercised only where hypothesis is installed
    from hypothesis import given, settings  # type: ignore[no-redef]
    from hypothesis import strategies as st  # type: ignore[no-redef]

    HAVE_HYPOTHESIS = True
except ImportError:
    HAVE_HYPOTHESIS = False

    _DEFAULT_MAX_EXAMPLES = 50

    class _Strategy:
        """A deterministic value generator: ``draw(rng) -> value``."""

        def __init__(self, draw: Callable[[random.Random], Any], name: str) -> None:
            self._draw = draw
            self._name = name

        def draw(self, rng: random.Random) -> Any:
            return self._draw(rng)

        def __repr__(self) -> str:
            return self._name

    class _St:
        @staticmethod
        def integers(min_value: int = -(2**31), max_value: int = 2**31) -> _Strategy:
            return _Strategy(
                lambda rng: rng.randint(min_value, max_value),
                f"integers({min_value}, {max_value})",
            )

        @staticmethod
        def floats(min_value: float = 0.0, max_value: float = 1.0, **_: Any) -> _Strategy:
            def draw(rng: random.Random) -> float:
                # Mix in the bounds occasionally: boundary values are where
                # properties break and uniform sampling rarely lands on them.
                r = rng.random()
                if r < 0.05:
                    return float(min_value)
                if r < 0.10:
                    return float(max_value)
                return rng.uniform(min_value, max_value)

            return _Strategy(draw, f"floats({min_value}, {max_value})")

        @staticmethod
        def booleans() -> _Strategy:
            return _Strategy(lambda rng: rng.random() < 0.5, "booleans()")

        @staticmethod
        def lists(elements: _Strategy, min_size: int = 0, max_size: int = 10) -> _Strategy:
            def draw(rng: random.Random) -> List[Any]:
                n = rng.randint(min_size, max_size)
                return [elements.draw(rng) for _ in range(n)]

            return _Strategy(draw, f"lists({elements!r}, {min_size}..{max_size})")

        @staticmethod
        def tuples(*elements: _Strategy) -> _Strategy:
            return _Strategy(
                lambda rng: tuple(e.draw(rng) for e in elements),
                f"tuples(×{len(elements)})",
            )

        @staticmethod
        def sampled_from(options: Sequence[Any]) -> _Strategy:
            opts = list(options)
            return _Strategy(lambda rng: rng.choice(opts), f"sampled_from({len(opts)})")

        @staticmethod
        def just(value: Any) -> _Strategy:
            return _Strategy(lambda rng: value, f"just({value!r})")

    st = _St()  # type: ignore[assignment]

    def settings(**kwargs: Any):  # type: ignore[no-redef]
        """Decorator recording ``max_examples``; other kwargs are ignored."""

        def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
            if "max_examples" in kwargs:
                fn._pt_max_examples = kwargs["max_examples"]  # type: ignore[attr-defined]
            return fn

        return deco

    def given(*gargs: _Strategy, **gkwargs: _Strategy):  # type: ignore[no-redef]
        def deco(fn: Callable[..., Any]) -> Callable[..., Any]:
            def runner(*call_args: Any, **call_kwargs: Any) -> None:
                n = getattr(runner, "_pt_max_examples", _DEFAULT_MAX_EXAMPLES)
                for i in range(n):
                    rng = random.Random(f"{fn.__module__}.{fn.__qualname__}#{i}")
                    args = [s.draw(rng) for s in gargs]
                    kwargs = {k: s.draw(rng) for k, s in gkwargs.items()}
                    try:
                        fn(*call_args, *args, **{**kwargs, **call_kwargs})
                    except Exception as exc:
                        raise AssertionError(
                            f"property falsified on example {i}/{n}: "
                            f"args={args!r} kwargs={kwargs!r}"
                        ) from exc

            # Present a bare callable to pytest: no __wrapped__, so the
            # collected signature has no parameters to mistake for fixtures.
            runner.__name__ = fn.__name__
            runner.__qualname__ = fn.__qualname__
            runner.__doc__ = fn.__doc__
            runner.__module__ = fn.__module__
            if hasattr(fn, "pytestmark"):
                runner.pytestmark = fn.pytestmark  # type: ignore[attr-defined]
            if hasattr(fn, "_pt_max_examples"):
                runner._pt_max_examples = fn._pt_max_examples  # type: ignore[attr-defined]
            return runner

        return deco
