"""A fixed time for every dispatch a ``TorchEngine`` consumes, for the
CPU tests that rank engines by live goodput.

On the card a dispatch's time barely grows with its rows; on a CPU
shared with other work it grows with them and with the host's load, so
a ranking by tokens per wall second would follow the host's speed. With
:func:`timed_dispatches` open, each decode window and mixed dispatch is
consumed ``delay_s`` seconds later: when the delay dominates the
compute, the wall is about ``delay_s`` times the dispatches, and goodput
ranks engines by how few dispatches they need for their tokens.
"""

import contextlib
import time


@contextlib.contextmanager
def timed_dispatches(delay_s: float):
    """Every ``TorchEngine`` consumes each dispatch (decode window or
    mixed) ``delay_s`` seconds later while the context is open."""
    from dynamo_exp_tpu_torch.engine import TorchEngine

    consumes = {name: getattr(TorchEngine, name)
                for name in ("_consume_windowed", "_consume_mixed")}

    def delayed(consume):
        def run(self, pending):
            time.sleep(delay_s)
            return consume(self, pending)
        return run

    for name, consume in consumes.items():
        setattr(TorchEngine, name, delayed(consume))
    try:
        yield
    finally:
        for name, consume in consumes.items():
            setattr(TorchEngine, name, consume)
