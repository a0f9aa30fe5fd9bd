"""FleetExecutor: the carrier / interceptor runtime (counterpart of
paddle_tpu/distributed/fleet_executor.py:1-322, copied: it is host-only).

Paddle's C++ FleetExecutor runs program sections as a DAG of TaskNodes:
each node is owned by an Interceptor (Source / Compute / Amplifier / Sink
behaviours), interceptors exchange InterceptorMessages through their
rank's Carrier, and bounded buffers give 1F1B-style credit flow control.
The same execution model, in-process:

* one Carrier per rank, owning the worker threads of its rank's
  interceptors;
* InterceptorMessage(src, dst, micro_step, payload) over bounded
  channels: a full channel blocks the producer (credit backpressure);
* interceptor behaviour by node_type: Source emits feeds, Compute runs
  the node's callable or section, Amplifier re-emits each upstream
  message `amplify` times, Sink collects results;
* a compute section is a callable (`run_fn(step, inputs)`) or a torch
  module (`program`), called with the section's feed dict as keyword
  arguments: the explicit feed merged with every upstream output that
  is a dict. PyTorch queues its kernels on the card; the threads only
  order them.
"""
from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Dict, List, Optional

__all__ = ["TaskNode", "FleetExecutor", "Carrier", "Interceptor",
           "InterceptorMessage"]


class _Stopped(Exception):
    """Internal: a sibling failed; unwind this worker quietly."""


class InterceptorMessage:
    """The upstream InterceptorMessage proto analog."""

    __slots__ = ("src", "dst", "micro_step", "payload")

    def __init__(self, src: int, dst: int, micro_step: int, payload):
        self.src = src
        self.dst = dst
        self.micro_step = micro_step
        self.payload = payload

    def __repr__(self):
        return (f"InterceptorMessage({self.src}->{self.dst}, "
                f"step={self.micro_step})")


class TaskNode:
    """One section of work, run `max_run_times` micro-steps."""

    _counter = [0]

    def __init__(self, rank: int = 0, node_type: str = "Compute",
                 task_id: Optional[int] = None,
                 program=None, run_fn: Optional[Callable] = None,
                 max_run_times: int = 1, amplify: int = 1):
        if task_id is None:
            task_id = TaskNode._counter[0]
            TaskNode._counter[0] += 1
        self.task_id = task_id
        self.rank = rank
        # Source/Sink/Amplifier get special interceptor behavior; any other
        # label (upstream also has Feed/Fetch/Cond roles) runs as Compute
        self.node_type = node_type
        self.program = program
        self.run_fn = run_fn
        self.max_run_times = max_run_times
        self.amplify = amplify          # Amplifier: out msgs per in msg
        self.downstream: Dict[int, int] = {}   # task_id -> buffer_size
        self.upstream: Dict[int, int] = {}

    def add_downstream_task(self, task_id: int, buffer_size: int = 2):
        self.downstream[task_id] = buffer_size
        return self

    def add_upstream_task(self, task_id: int, buffer_size: int = 2):
        self.upstream[task_id] = buffer_size
        return self

    def __repr__(self):
        return (f"TaskNode(id={self.task_id}, type={self.node_type}, "
                f"rank={self.rank}, up={sorted(self.upstream)}, "
                f"down={sorted(self.downstream)})")


class Interceptor:
    """Owns one TaskNode: receives messages for it, runs its behavior,
    emits messages downstream through the carrier."""

    def __init__(self, node: TaskNode, carrier: "Carrier", run):
        self.node = node
        self.carrier = carrier
        self._run = run           # shared run-state (channels, results, ...)

    # -- channel helpers (credit-based: bounded queues block) -------------
    def _recv(self, src: int, q):
        run = self._run
        while True:
            if run.stop.is_set():
                raise _Stopped()
            try:
                msg = q.get(timeout=0.05)
                assert msg.dst == self.node.task_id
                return msg
            except queue.Empty:
                if time.monotonic() > run.deadline:
                    raise TimeoutError(
                        f"interceptor {self.node.task_id} timed out waiting "
                        f"on {src}")

    def _send(self, dst: int, micro_step: int, payload):
        run = self._run
        q = run.channels[(self.node.task_id, dst)]
        msg = InterceptorMessage(self.node.task_id, dst, micro_step, payload)
        while True:
            if run.stop.is_set():
                raise _Stopped()
            try:
                return q.put(msg, timeout=0.05)
            except queue.Full:
                if time.monotonic() > run.deadline:
                    raise TimeoutError(
                        f"interceptor {self.node.task_id} -> {dst} "
                        "backpressured past the deadline")

    # -- behaviors --------------------------------------------------------
    def run_loop(self):
        node = self.node
        run = self._run
        try:
            if node.node_type == "Amplifier":
                self._amplifier_loop()
                return
            for step in range(node.max_run_times):
                if run.stop.is_set():
                    return
                inputs = {}
                for src in node.upstream:
                    msg = self._recv(src, run.channels[(src, node.task_id)])
                    inputs[src] = msg.payload
                if node.task_id in run.feed:
                    inputs["feed"] = run.feed[node.task_id][step]
                out = self._compute(step, inputs)
                run.results[node.task_id].append(out)
                for dst in node.downstream:
                    self._send(dst, step, out)
        except _Stopped:
            return
        except Exception as e:   # surface to the caller, stop the DAG
            run.errors.append(e)
            run.stop.set()

    def _amplifier_loop(self):
        """Upstream's amplifier interceptor: every upstream message is
        re-emitted `amplify` times (micro-batch fan-out for 1F1B traffic
        shaping); runs until its upstreams complete."""
        node = self.node
        run = self._run
        out_step = 0
        for step in range(node.max_run_times):
            if run.stop.is_set():
                return
            for src in node.upstream:
                msg = self._recv(src, run.channels[(src, node.task_id)])
                for _ in range(max(1, node.amplify)):
                    run.results[node.task_id].append(msg.payload)
                    for dst in node.downstream:
                        self._send(dst, out_step, msg.payload)
                    out_step += 1

    def _compute(self, step: int, inputs):
        node = self.node
        if node.run_fn is not None:
            return node.run_fn(step, inputs)
        if node.program is not None:
            # sections take dict feeds: the explicit feed plus every
            # upstream output that is a dict (fetches by name)
            section_feed = dict(inputs.get("feed") or {})
            for src in node.upstream:
                if isinstance(inputs[src], dict):
                    section_feed.update(inputs[src])
            return node.program(**section_feed)
        # Source/Sink without a callable: pass the feed / inputs through
        if node.node_type == "Source":
            return inputs.get("feed")
        if len(inputs) == 1:
            return next(iter(inputs.values()))
        return inputs


class Carrier:
    """One rank's interceptor host: creates the rank's interceptors and
    drives each on its own worker thread (upstream: carrier.cc). Cross-rank
    messages ride the shared channel table — the in-process message bus."""

    def __init__(self, rank: int):
        self.rank = rank
        self.interceptors: Dict[int, Interceptor] = {}
        self._threads: List[threading.Thread] = []

    def create_interceptor(self, node: TaskNode, run) -> Interceptor:
        ic = Interceptor(node, self, run)
        self.interceptors[node.task_id] = ic
        return ic

    def start(self):
        self._threads = [
            threading.Thread(target=ic.run_loop, daemon=True,
                             name=f"carrier{self.rank}-ic{tid}")
            for tid, ic in self.interceptors.items()]
        for t in self._threads:
            t.start()

    def join(self, timeout: float):
        for t in self._threads:
            t.join(timeout=timeout)

    def alive(self) -> bool:
        return any(t.is_alive() for t in self._threads)


class _RunState:
    """Shared per-run state: the message bus (channel table), results,
    stop flag, deadline."""

    def __init__(self, channels, feed, results, deadline):
        self.channels = channels
        self.feed = feed
        self.results = results
        self.errors: List[BaseException] = []
        self.stop = threading.Event()
        self.deadline = deadline


class FleetExecutor:
    """Execute a TaskNode DAG through per-rank Carriers of Interceptors."""

    def __init__(self, task_nodes: Optional[List[TaskNode]] = None):
        self._nodes: Dict[int, TaskNode] = {}
        self.carriers: Dict[int, Carrier] = {}
        if task_nodes:
            self.init(task_nodes)

    def init(self, task_nodes: List[TaskNode]):
        self._nodes = {n.task_id: n for n in task_nodes}
        # symmetrize edges so users may declare only one direction
        for n in task_nodes:
            for tid, buf in n.downstream.items():
                self._nodes[tid].upstream.setdefault(n.task_id, buf)
            for tid, buf in n.upstream.items():
                self._nodes[tid].downstream.setdefault(n.task_id, buf)
        self._validate_acyclic()
        self.carriers = {}
        for n in task_nodes:
            self.carriers.setdefault(n.rank, Carrier(n.rank))
        return self

    def _validate_acyclic(self):
        state: Dict[int, int] = {}

        def visit(tid):
            if state.get(tid) == 1:
                raise ValueError("TaskNode graph has a cycle")
            if state.get(tid) == 2:
                return
            state[tid] = 1
            for d in self._nodes[tid].downstream:
                visit(d)
            state[tid] = 2

        for tid in self._nodes:
            visit(tid)

    def run(self, feed=None, fetch_task_ids: Optional[List[int]] = None,
            timeout: float = 300.0):
        """Drive every interceptor for its node's micro-steps.

        `feed`: optional {task_id: [per-step inputs]} for source nodes.
        Returns {task_id: [per-step outputs]} for `fetch_task_ids` (default:
        all sink nodes).
        """
        feed = feed or {}
        channels: Dict[tuple, queue.Queue] = {}
        for n in self._nodes.values():
            for dst, buf in n.downstream.items():
                channels[(n.task_id, dst)] = queue.Queue(maxsize=max(1, buf))

        sinks = [tid for tid, n in self._nodes.items() if not n.downstream]
        fetch_ids = list(fetch_task_ids or sinks)
        results: Dict[int, List] = {tid: [] for tid in self._nodes}
        run = _RunState(channels, feed, results,
                        time.monotonic() + timeout)

        for n in self._nodes.values():
            self.carriers[n.rank].create_interceptor(n, run)
        for c in self.carriers.values():
            c.start()
        for c in self.carriers.values():
            c.join(timeout=timeout)
        try:
            if run.errors:
                raise run.errors[0]
            if any(c.alive() for c in self.carriers.values()):
                run.stop.set()
                raise TimeoutError("FleetExecutor DAG did not complete")
            return {tid: results[tid] for tid in fetch_ids}
        finally:
            # drop per-run interceptors: they hold the _RunState (results,
            # feeds, channel payloads) and would pin a finished run's data
            # for the executor's lifetime
            for c in self.carriers.values():
                c.interceptors.clear()
                c._threads = []
