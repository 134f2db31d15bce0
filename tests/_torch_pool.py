"""Collators for the port's CollatorPool tests (tests/test_torch_loop_options.py).

They live in a module of their own, importing neither JAX nor the JAX
package, because spawn-started pool workers import the module that
defines a collator to unpickle it."""

import time


class RaisingCollator:
    """Collates with ``inner``, but raises on a batch that holds the group
    whose first question id is ``qid``."""

    def __init__(self, inner, qid):
        self.inner = inner
        self.qid = qid

    def __call__(self, items, rng=None):
        if any(it["examples"][0]["question_id"] == self.qid for it in items):
            raise ValueError(f"collator refused question {self.qid}")
        return self.inner(items, rng=rng)


class SleepingCollator:
    """Collates with ``inner`` after sleeping ``seconds``."""

    def __init__(self, inner, seconds):
        self.inner = inner
        self.seconds = seconds

    def __call__(self, items, rng=None):
        time.sleep(self.seconds)
        return self.inner(items, rng=rng)
