"""Sharded serving's command stream: rank 0 leads, the other ranks replay.

The JAX package runs one controller over every device of a mesh. PyTorch
runs one process per device, so a :class:`~repro_torch.serving.ModelRegistry`
on a mesh has a leader, rank 0, which runs the control plane (HTTP,
admission, the scheduler), and followers, which run :func:`follow`: they
repeat every step rank 0 takes on its device, in the order rank 0 takes it.

* ``register`` / ``swap`` — a model: the path it was loaded from (the
  followers load it themselves) or its host arrays;
* ``batch`` — ``(model, n, sampler, seed, pad_to)``: the follower makes
  the same :meth:`~repro_torch.serving.ModelRegistry.dispatch` (acquire,
  so its placement makes the promotions and LRU demotions rank 0's made,
  then the sharded ``sample_async``, whose gathers pair with rank 0's);
* ``impute`` — ``(model, rows, labels, seed, refine_rounds)``, the model
  rows rank 0 checked: the follower makes the same
  :meth:`~repro_torch.serving.ModelRegistry.impute_part` (its classes'
  rows, then the gathers that pair with rank 0's);
* ``stop`` — the followers leave :func:`follow`.

Commands travel on a gloo side group (``broadcast_object_list`` on NCCL
needs CUDA tensors). Rank 0 publishes a command and applies it under one
lock (:attr:`CommandStream.lock`): a batch's acquire, its publication and
its enqueue are one step, and so is a register or swap. The commands and
the collectives they announce therefore keep one order on every rank,
whichever of rank 0's threads issues them, and a batch meets the same
model version on every rank.

A failure after a command was published is fatal to the stream: the ranks'
collectives no longer pair. :meth:`CommandStream.abort` marks it broken
(every later command raises :class:`StreamBroken`, so no later batch
returns rows) and calls ``on_break`` (``serve_http`` stops serving and
exits non-zero). A batch or an impute has one failure check,
:meth:`CommandStream.settle`: every rank reports on the gloo side group
whether its part reached its first gather (or failed before it), and
every rank enters that gather only if all did. A rank whose part fails
reports the failure there; so rank 0 raises as soon as a follower's
replay fails, and a follower as soon as rank 0's part fails, instead of
waiting in a gather that will not pair (an NCCL gather does not notice a
peer that left). A follower whose replay fails raises out of
:func:`follow`.
"""
from __future__ import annotations

import dataclasses
import datetime
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.tabgen.artifacts import (_TENSOR_FIELDS, ForestArtifacts,
                                          artifacts_from_numpy)

# a follower of an idle server waits for its next command this long
IDLE_TIMEOUT = datetime.timedelta(days=7)
# the failure check waits this long for the slowest rank's part of a batch
SETTLE_TIMEOUT = datetime.timedelta(minutes=5)
# the commands whose collectives the failure check guards
_CHECKED = ("batch", "impute")


class StreamBroken(RuntimeError):
    """A command failed after its publication: the ranks no longer agree on
    what comes next, and the mesh serves nothing more."""


class CommandStream:
    """Rank 0's commands to the other ranks of the process group.

    Construct it on every rank at the same point (it creates the gloo side
    group, a collective). On one rank there is no one to tell: publishing
    sends nothing, and a failure breaks nothing.
    """

    def __init__(self):
        if not dist.is_initialized():
            raise RuntimeError("a command stream needs an initialised "
                               "process group")
        self.rank = dist.get_rank()
        self.world = dist.get_world_size()
        self.group = (dist.new_group(backend="gloo", timeout=IDLE_TIMEOUT)
                      if self.world > 1 else None)
        # held from a command's publication until it is applied (a batch:
        # enqueued)
        self.lock = threading.RLock()
        self.closed = False
        self.broken: Optional[BaseException] = None
        # called once, from the thread that broke the stream
        self.on_break: Optional[Callable[[], None]] = None
        # a batch or impute published (received) whose failure check is due
        self.pending = False

    @property
    def leader(self) -> bool:
        return self.rank == 0

    def publish(self, op: str, **args) -> None:
        """Send one command (rank 0, with :attr:`lock` held). A follower's
        registry replaying a command publishes nothing."""
        if not self.leader:
            return
        if self.broken is not None:
            raise StreamBroken(
                f"the command stream broke ({self.broken!r}): restart the "
                "mesh") from self.broken
        if self.closed:
            raise RuntimeError("the command stream is closed: the other "
                               "ranks have left")
        if op == "stop":
            self.closed = True
        if self.group is not None:
            dist.broadcast_object_list([(op, args)], src=0, group=self.group)
            self.pending = op in _CHECKED

    def settle(self, failure: Optional[BaseException] = None) -> None:
        """The failure check of a published batch or impute, on every rank
        once: ``failure`` is this rank's exception if its part failed,
        ``None`` when the part reached its first gather. Raises
        :class:`StreamBroken` there if any rank failed (or the check itself
        did: a rank left, or did not report within ``SETTLE_TIMEOUT``). A
        failing rank only reports: its own exception is the one it raises.
        Nothing to do on one rank, or with no check due."""
        if not self.pending:
            return
        self.pending = False
        flag = torch.tensor([0 if failure is None else 1], dtype=torch.int32)
        try:
            dist.all_reduce(flag, group=self.group,
                            async_op=True).wait(SETTLE_TIMEOUT)
        except RuntimeError as exc:
            if failure is None:
                raise StreamBroken(f"the failure check failed ({exc!r}): "
                                   "restart the mesh") from exc
            return
        if failure is None and int(flag) > 0:
            raise StreamBroken(
                f"{int(flag)} rank(s) failed their part of this command "
                "before its gather: restart the mesh")

    def abort(self, exc: BaseException) -> None:
        """``exc`` struck after a publication: on more than one rank, break
        the stream."""
        if self.group is None or self.broken is not None:
            return
        self.broken = exc
        if self.on_break is not None:
            self.on_break()

    def receive(self) -> Tuple[str, dict]:
        """The next command (a follower)."""
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]


def model_payload(artifacts: ForestArtifacts, path: Optional[str]) -> dict:
    """What a register or swap command carries of its model: the path the
    followers load, or the host arrays, config and lineage."""
    if path is not None:
        return {"path": path}
    arrays = {f: getattr(artifacts, f).cpu().numpy() for f in _TENSOR_FIELDS}
    arrays.update(classes=np.asarray(artifacts.classes),
                  counts=np.asarray(artifacts.counts))
    return {"arrays": arrays, "config": dataclasses.asdict(artifacts.config),
            "lineage": artifacts.lineage}


def payload_model(payload: dict):
    """``(artifacts on the CPU, schema or None)`` of a command's model."""
    if "path" in payload:
        from repro_torch.tabgen import TabularGenerator
        gen = TabularGenerator.load(payload["path"], device="cpu")
        return gen.artifacts, gen.schema
    art = artifacts_from_numpy(payload["arrays"], payload["config"], "cpu")
    return dataclasses.replace(art, lineage=payload["lineage"]), None


def _schema(payload: Optional[dict]):
    if payload is None:
        return None
    from repro_torch.core.mixed_types import TabularSchema
    return TabularSchema.from_dict(payload)


def follow(registry) -> int:
    """A follower's loop: replay rank 0's commands on ``registry`` (a
    registry on the same mesh, built at the same point) until ``stop``.
    Returns the number of batches replayed; a failed replay raises."""
    stream = registry.stream
    if stream is None or stream.leader:
        raise ValueError("follow() runs on a rank > 0 of a registry's mesh")
    batches = 0
    while True:
        op, args = stream.receive()
        if op == "stop":
            stream.closed = True
            return batches
        stream.pending = op in _CHECKED
        try:
            batches += _replay(registry, op, args)
        except BaseException as exc:
            stream.settle(exc)          # rank 0 learns of it at its check
            raise


def _replay(registry, op: str, args: dict) -> int:
    """Apply one command of rank 0's on a follower; returns the batches it
    replayed (0 or 1)."""
    if op in ("register", "swap"):
        art, schema = payload_model(args["model"])
        schema = schema or _schema(args["schema"])
        if op == "register":
            registry.register(args["name"], art, schema=schema,
                              samplers=args["samplers"],
                              buckets=args["buckets"], hot=args["hot"])
        else:
            registry.swap(args["name"], art, schema=schema,
                          keep_schema=args["keep_schema"])
    elif op == "batch":
        _, sample = registry.dispatch(
            args["model"], args["n"], args["sampler"], seed=args["seed"],
            pad_to=args["pad_to"])
        ready = getattr(sample, "ready", None)
        if ready is not None:
            ready.synchronize()
        return 1
    elif op == "impute":
        registry.impute_part(args["model"], args["rows"], args["labels"],
                             seed=args["seed"],
                             refine_rounds=args["refine_rounds"])
    else:
        raise ValueError(f"unknown command {op!r}")
    return 0
