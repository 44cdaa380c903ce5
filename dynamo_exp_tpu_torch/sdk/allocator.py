"""Card allocation for the services of one host.

Counterpart of ``dynamo_exp_tpu/sdk/allocator.py``'s ``TPUAllocator``:
each worker process of a service that asks for cards
(``resources={"gpu": n}``) gets ``CUDA_VISIBLE_DEVICES`` from a free set
of slots; a host-side service (Frontend, Processor) gets
``CUDA_VISIBLE_DEVICES=""``, so it can never take a card. The slots are
device ordinals, one a visible card by default, or given
(``--cuda-devices`` / ``DYN_CUDA_DEVICES``, e.g. ``0,0``): an ordinal
may repeat, and then that many workers share the card. An ordinal
counts among the cards this process sees: under an inherited
``CUDA_VISIBLE_DEVICES=3,5`` slot 0 is card 3 and slot 1 card 5, as
``torch.cuda`` would number them. Released slots return to the free
set, so the planner's scale-down frees budget for the next scale-up.
"""

from __future__ import annotations

import os

ENV_VAR = "DYN_CUDA_DEVICES"


class AllocationError(RuntimeError):
    pass


def inherited_cards() -> list[str] | None:
    """This process's ``CUDA_VISIBLE_DEVICES`` entries (indices or
    UUIDs, as given), or None when it is unset."""
    env = os.environ.get("CUDA_VISIBLE_DEVICES")
    if env is None:
        return None
    return [x.strip() for x in env.split(",") if x.strip()]


def visible_card_count() -> int:
    """Cards this host shows, without touching CUDA in this process:
    the ``CUDA_VISIBLE_DEVICES`` list when set, else ``nvidia-smi``'s
    count (0 without one)."""
    import shutil
    import subprocess

    cards = inherited_cards()
    if cards is not None:
        return len(cards)
    if shutil.which("nvidia-smi") is None:
        return 0
    try:
        out = subprocess.run(["nvidia-smi", "--list-gpus"], capture_output=True, text=True,
                             timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return 0
    return sum(1 for line in out.splitlines() if line.startswith("GPU "))


def parse_devices(spec: str) -> list[int]:
    """``"0,0,1"`` -> [0, 0, 1]; each entry a device ordinal >= 0."""
    ids = [int(x) for x in spec.split(",") if x.strip()]
    if any(i < 0 for i in ids):
        raise ValueError(f"device ordinals must be >= 0: {spec!r}")
    return ids


class CudaAllocator:
    """Free-list allocator over card slots: slots released by a
    scaled-down worker go to the next scale-up. A slot's ordinal is
    mapped through the inherited ``CUDA_VISIBLE_DEVICES`` (when set) to
    the card the child is given."""

    def __init__(self, devices: list[int] | str | None = None):
        if devices is None:
            devices = os.environ.get(ENV_VAR) or list(range(visible_card_count()))
        if isinstance(devices, str):
            devices = parse_devices(devices)
        self.slots = list(devices)
        cards = inherited_cards()
        if cards is None:
            self._cards = [str(i) for i in range(max(self.slots, default=-1) + 1)]
        else:
            self._cards = cards
            if any(i >= len(cards) for i in self.slots):
                raise AllocationError(
                    f"card slots {self.slots} name ordinals beyond the {len(cards)} card(s) "
                    f"of CUDA_VISIBLE_DEVICES={','.join(cards)!r}")
        self._free = list(range(len(self.slots)))  # slot indices, lowest first

    @property
    def total(self) -> int:
        return len(self.slots)

    @property
    def available(self) -> int:
        return len(self._free)

    def assign(self, service_name: str, gpus: int) -> dict[str, str]:
        """Env vars for one worker process of ``service_name``."""
        if gpus <= 0:
            return {"CUDA_VISIBLE_DEVICES": ""}
        if gpus > len(self._free):
            raise AllocationError(
                f"{service_name} wants {gpus} card slot(s) but only {len(self._free)} "
                f"of {self.total} remain"
            )
        taken = sorted(self._free)[:gpus]
        self._free = [i for i in self._free if i not in taken]
        return {
            "CUDA_VISIBLE_DEVICES": ",".join(self._cards[self.slots[i]] for i in taken),
            "DYN_CUDA_SLOTS": ",".join(str(i) for i in taken),
        }

    def release(self, env: dict[str, str]) -> None:
        """Return a worker's slots (from its assign() env) to the pool."""
        taken = env.get("DYN_CUDA_SLOTS", "")
        if taken:
            self._free = sorted(set(self._free) | {int(i) for i in taken.split(",")})
