"""The rendezvous actor of the host collective group
(`parallel/collective.py` `HostGroup`), in a module of its own that
imports numpy only, so that the actor's process starts without torch.
The reduction rule is the reference's: numpy over the ranks' arrays, in
rank order."""

from typing import Dict

import numpy as np


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MAX = "max"
    MIN = "min"


_NUMPY_REDUCE = {
    ReduceOp.SUM: lambda xs: np.sum(xs, axis=0),
    ReduceOp.PRODUCT: lambda xs: np.prod(xs, axis=0),
    ReduceOp.MAX: lambda xs: np.max(xs, axis=0),
    ReduceOp.MIN: lambda xs: np.min(xs, axis=0),
}


class _RendezvousActor:
    """Async actor: one instance per group; every collective is a keyed
    barrier where the last arriving rank computes the result."""

    def __init__(self, world_size: int):
        import asyncio
        self.world_size = world_size
        self.pending: Dict[str, dict] = {}
        self.mailbox: Dict[tuple, object] = {}
        self.mail_events: Dict[tuple, object] = {}
        self._asyncio = asyncio
        self._bytes_seen = {"collective": 0, "p2p": 0}

    @staticmethod
    def _size(data) -> int:
        if hasattr(data, "nbytes"):       # a numpy array or a tensor
            return data.nbytes
        if isinstance(data, (list, tuple)):
            return sum(_RendezvousActor._size(d) for d in data)
        return 64  # refs / scalars / None: envelope-sized

    def _slot(self, key):
        slot = self.pending.get(key)
        if slot is None:
            slot = {"data": {}, "event": self._asyncio.Event(), "result": None}
            self.pending[key] = slot
        return slot

    async def collective(self, key: str, rank: int, data, op: str, kind: str):
        self._bytes_seen["collective"] += self._size(data)
        slot = self._slot(key)
        slot["data"][rank] = data
        if len(slot["data"]) == self.world_size:
            ordered = [slot["data"][r] for r in range(self.world_size)]
            if kind == "allreduce" or kind == "reduce":
                slot["result"] = _NUMPY_REDUCE[op](np.stack(ordered))
            elif kind == "allgather":
                slot["result"] = ordered
            elif kind == "reducescatter":
                red = _NUMPY_REDUCE[op](np.stack(ordered))
                slot["result"] = np.array_split(red, self.world_size)
            elif kind == "broadcast":
                slot["result"] = next(d for d in ordered if d is not None)
            elif kind == "barrier":
                slot["result"] = True
            elif kind == "alltoall":
                # ordered[r] is a list of world_size chunks from rank r
                slot["result"] = [[ordered[src][dst] for src in range(self.world_size)]
                                  for dst in range(self.world_size)]
            slot["event"].set()
        else:
            await slot["event"].wait()
        result = slot["result"]
        slot.setdefault("consumed", 0)
        slot["consumed"] += 1
        if slot["consumed"] == self.world_size:
            del self.pending[key]
        if kind in ("reducescatter", "alltoall"):
            return result[rank]
        if kind == "reduce":
            return result if data is not None else None
        return result

    async def send(self, key: tuple, data):
        self._bytes_seen["p2p"] += self._size(data)
        ev = self.mail_events.get(key)
        self.mailbox[key] = data
        if ev is None:
            self.mail_events[key] = self._asyncio.Event()
        self.mail_events[key].set()

    async def recv(self, key: tuple):
        if key not in self.mail_events:
            self.mail_events[key] = self._asyncio.Event()
        await self.mail_events[key].wait()
        data = self.mailbox.pop(key)
        del self.mail_events[key]
        return data

    def stats(self):
        """Rough payload accounting: the routing payloads arrive as ref
        envelopes, so the data plane bypasses this actor."""
        return dict(self._bytes_seen)
