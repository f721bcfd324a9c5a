"""DevicePlacement: session -> device affinity for the sharded service.

The port of `repro.serve3d.placement`, with the same policy.  Every
admitted session is assigned one slot (a device), and its whole training
state -- params, Adam moments, occupancy grid, ray sampler -- lives on that
device until the session finishes or is moved.  Sessions are sharded,
tensors are not: no collective runs, and the single-device service's
bit-identity contracts carry over, since training math never crosses a
device.

Policy: deterministic least-loaded.  `assign` picks the slot with the
fewest live sessions, ties going to the lowest slot, and is sticky: a
placed session keeps its slot, so suspend / resume keeps its device.
`move` re-homes a session to an explicit slot or to the least-loaded other
one; the caller suspends before and resumes after, and since resume is
bit-exact and the draw streams are keyed by the absolute step, the move is
bit-transparent.  `release` takes a finished or quarantined session off the
load books but keeps its mapping, so its snapshots still render on its
device.  The scheduler's ``max_resident`` is a per-device cap once a
placement is attached.

Devices: an int (the first n cards, `launch.mesh.session_devices`), an
explicit list -- `torch.device`s, strings such as ``"cuda:0"`` or
``"cpu"``, duplicates allowed (two slots on one card), or opaque labels
for bookkeeping alone -- or None for every card.
"""
from __future__ import annotations

from ..launch.mesh import session_devices


class DevicePlacement:
    def __init__(self, devices=None):
        """devices: an int (the first n cards), an explicit device list, or
        None (every card)."""
        if devices is None or isinstance(devices, int):
            devices = session_devices(devices)
        self.devices = list(devices)
        if not self.devices:
            raise ValueError("DevicePlacement needs at least one device")
        self._slot: dict[str, int] = {}     # session_id -> slot
        self._load: list[int] = [0] * len(self.devices)
        self._released: set[str] = set()    # finished: off the load books

    @property
    def n(self) -> int:
        return len(self.devices)

    # ---- assignment ----

    def assign(self, session_id: str) -> int:
        """Sticky least-loaded slot for this session (ties -> lowest slot)."""
        slot = self._slot.get(session_id)
        if slot is not None:
            return slot
        slot = min(range(self.n), key=lambda i: (self._load[i], i))
        self._slot[session_id] = slot
        self._load[slot] += 1
        return slot

    def move(self, session_id: str, slot: int | None = None) -> int:
        """Re-home a session: to an explicit slot, or to the least-loaded
        other slot.  Only the affinity changes; the caller moves the state
        (suspend before, resume after)."""
        old = self._slot.get(session_id)
        if old is None:
            raise KeyError(f"unplaced session {session_id!r}")
        if slot is None:
            others = [i for i in range(self.n) if i != old] or [old]
            slot = min(others, key=lambda i: (self._load[i], i))
        slot = int(slot)
        if not 0 <= slot < self.n:
            raise ValueError(f"slot {slot} out of range for {self.n} devices")
        if slot != old:
            if session_id not in self._released:
                self._load[old] -= 1
                self._load[slot] += 1
            self._slot[session_id] = slot
        return slot

    def release(self, session_id: str) -> None:
        """Take a finished or quarantined session off the load books; its
        slot mapping stays, so its snapshots keep rendering there."""
        slot = self._slot.get(session_id)
        if slot is not None and session_id not in self._released:
            self._released.add(session_id)
            self._load[slot] -= 1

    # ---- lookup ----

    def slot(self, session_id: str) -> int | None:
        return self._slot.get(session_id)

    def device(self, session_id: str):
        """The device holding this session's state (None when unplaced)."""
        slot = self._slot.get(session_id)
        return None if slot is None else self.devices[slot]

    def device_for_slot(self, slot: int):
        return self.devices[slot]

    def loads(self) -> list[int]:
        return list(self._load)

    def stats(self) -> dict:
        return {
            "devices": [str(d) for d in self.devices],
            "loads": self.loads(),
            "placed": dict(self._slot),
        }
