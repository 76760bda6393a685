"""Partition a generated substep's operations over the warps that share 32 envs.

The articulated kernel runs ``G`` warps on each group of 32 envs: lane ``l``
of every warp is env ``l``, and warp ``g`` runs partition ``g`` of the
substep's operation DAG. This module makes that partition on the CPU, from
the live body nodes of :mod:`gymnasium_tpu_torch.ops.codegen`:

- every node goes to one partition and one **phase**. Between phases the
  group's warps meet at a barrier, and a node may read a value that another
  partition made only in an earlier phase; that value goes through shared
  memory (one store by its owner, one load by each partition that reads it);
- a node whose single user is another node stays with that user, so the
  chains that feed one value (a contact's force, a mass-matrix entry with
  its Jacobian products, a running sum) never cross partitions; the sine
  and cosine of one angle stay together, to be emitted as one ``sincosf``
  (its range reduction once: less code for the warp to fetch). These
  clusters are placed by a greedy list schedule: phase by phase, the least
  loaded partition takes the ready cluster of highest priority (its longest
  latency path to an output), less a penalty for each operand it would have
  to load; a partition may chain its own results within a phase. The phase
  budget is chosen among a few by the schedule's estimated time;
- a cheap node (one add, multiply, compare, select...) that another
  partition would load is recomputed there instead when that partition
  already holds its operands. Each recomputation is listed;
- exchanged values share slots where their lifetimes, in phases, do not
  overlap. The first ``carried`` slots hold the values carried from one
  substep to the next.

Every node is still the same operation on the same operands, so every value
keeps its bits. With one partition there is nothing to place.
:func:`layout_clocks` is the model that ranks the layouts of a placement
(warps a group, groups a block) on the card.

The planar kernel lays one env over a group of ``G`` lanes of one warp
instead (:func:`lane_schedule`). Lanes of a warp issue one instruction
stream, so a phase runs in parallel only where its lanes run the same
operations on their own operands. The schedule therefore places whole
**units** (a body, a contact probe, a joint: the pieces the generator
traces under ``ops.unit``) on fixed lanes, and a phase holds units of one
shape, one a lane. A unit is the cluster the rules above would keep
together: it holds every node whose value only it uses, a sine and cosine
of one angle, and its own copy of a node that another unit also computes
(recomputed, not exchanged). Loop bodies traced under ``SymOps.repeat``
are scheduled like straight-line code, with sincos nodes; the values they
carry stay with the units that own them. What crosses lanes goes through
``__shfl_sync`` within the group; its cost and the phases' are in
:data:`LATENCY`, :data:`SHUFFLE` and :data:`SELECT` (a ``__syncwarp`` of
the group, not a block barrier).
"""

from __future__ import annotations

import collections
import dataclasses
import heapq

import numpy as np

__all__ = ["WarpPartition", "partition", "layout_clocks", "sincos_pairs", "SHARED_BYTES_MAX", "ONE_GROUP_SLOTS",
           "lane_schedule", "unit_shape"]

#: Latency in clocks of one operation, as the schedule counts it: sqrt and
#: the IEEE divide 20, sin, cos and one sincosf 40, everything else 4.
LATENCY = collections.defaultdict(lambda: 4, {"div": 20, "sqrt": 20, "sin": 40, "cos": 40, "sincos": 40})
SHUFFLE = 8  # clocks a __shfl_sync within a lane group adds to its phase
SELECT = 4  # clocks a select between two lanes' operands adds
_EXCHANGE = 4  # clocks a shared-memory store or load adds to its warp's phase
_BARRIER = 40  # clocks a barrier between phases costs
_LOAD_PENALTY = 12  # priority a cluster loses for each operand its partition must load
_CHEAP = frozenset({"add", "sub", "mul", "neg", "max", "min", "gt", "lt", "ge", "or", "select"})
_BUDGET_FRACTIONS = (1 / 32, 1 / 16, 1 / 8, 1 / 4, 1 / 2)
#: Shared memory one block may use on an H100 (227 KB, dynamic above 48 KB).
SHARED_BYTES_MAX = 232_448
ONE_GROUP_SLOTS = SHARED_BYTES_MAX // (4 * 32)  # the most exchange slots one group of a block may have


@dataclasses.dataclass(frozen=True)
class WarpPartition:
    """Where each body node of one substep runs, and what the warps exchange.

    ``blocks[k][p]`` are the nodes partition ``p`` computes in phase ``k``
    (recomputations included), in creation order; ``loads[k][p]`` the
    ``(node, slot)`` it reads from shared memory at the start of that phase,
    ``stores[k][p]`` those it writes at its end.
    """

    parts: int
    phases: int
    blocks: list
    loads: list
    stores: list
    owner: dict  # node id -> the partition that computes it
    recomputed: list  # (node, partition, phase): computed again there
    slots: int  # exchange floats an env, the carried slots first
    carried: int
    estimate: int  # clocks of one substep in the schedule's own cost model (not a measurement)
    segments: list  # [phase][part]: clocks in the cost model
    issues: list  # [phase][part]: statements, loads and stores issued
    moved: list  # [phase][part]: values loaded and stored
    live: list  # [part]: the most values held in registers across a phase boundary

    @property
    def exchanged(self) -> int:
        """Values that cross partitions through shared memory, a substep."""
        return sum(len(s) for phase in self.stores for s in phase)

    @property
    def exchange_loads(self) -> int:
        return sum(len(s) for phase in self.loads for s in phase)

    def shared_bytes(self, groups: int) -> int:
        """Exchange buffer of a block of ``groups`` groups of 32 envs."""
        return 4 * 32 * self.slots * groups


def sincos_pairs(nodes):
    """``(sin, cos)`` node pairs of one argument among ``nodes``."""
    sines = {n.args[0].id: n for n in nodes if n.kind == "sin"}
    return [(sines[n.args[0].id], n) for n in nodes if n.kind == "cos" and n.args[0].id in sines]


class _Graph:
    """The body nodes as indices: operands, users, costs, priorities, clusters."""

    def __init__(self, body):
        self.body = body
        index = {n.id: i for i, n in enumerate(body)}
        self.n = len(body)
        self.preds = [sorted({index[a.id] for a in n.args if a.id in index}) for n in body]
        self.users = [[] for _ in body]
        for i, ps in enumerate(self.preds):
            for j in ps:
                self.users[j].append(i)
        self.cost = [LATENCY[n.kind] for n in body]
        self.level = [0] * self.n  # longest latency path to an output
        for i in reversed(range(self.n)):
            self.level[i] = self.cost[i] + max((self.level[u] for u in self.users[i]), default=0)
        # a node with one user joins that user's cluster, and the sine and
        # cosine of one angle share a cluster, so they can be one sincosf
        root = list(range(self.n))
        for i in reversed(range(self.n)):
            if len(self.users[i]) == 1:
                root[i] = root[self.users[i][0]]
        for i, j in sincos_pairs(body):
            i, j = index[i.id], index[j.id]
            if root[i] == i and root[j] == j:  # each read by several nodes: no cycle can form
                root = [i if r == j else r for r in root]
        self.cluster = root
        members = collections.defaultdict(list)
        for i in range(self.n):
            members[root[i]].append(i)
        self.members = dict(members)
        self.ext = {c: sorted({j for i in m for j in self.preds[i] if root[j] != c}) for c, m in members.items()}
        self.ext_set = {c: frozenset(ext) for c, ext in self.ext.items()}
        self.cusers = collections.defaultdict(set)
        for c, ext in self.ext.items():
            for j in ext:
                self.cusers[root[j]].add(c)
        self.ccost = {c: sum(self.cost[i] for i in m) for c, m in members.items()}
        self.clevel = {c: max(self.level[i] for i in m) for c, m in members.items()}


def _place(g: _Graph, parts: int, budget: float):
    """Greedy phase schedule of the clusters; returns (phase, part) by cluster."""
    remaining = {c: len({g.cluster[j] for j in ext}) for c, ext in g.ext.items()}
    where: dict = {}
    pool = [(-g.clevel[c], c) for c, r in remaining.items() if r == 0]
    heapq.heapify(pool)
    held = [set() for _ in range(parts)]
    phase = 0
    while len(where) < len(g.members):
        local = [[] for _ in range(parts)]
        load = [0.0] * parts
        idle = [False] * parts
        blocked = []

        def missing(c, p):
            return len(g.ext_set[c] - held[p])

        while True:
            open_parts = [p for p in range(parts) if not idle[p] and load[p] < budget]
            if not open_parts:
                break
            p = min(open_parts, key=lambda q: load[q])
            while local[p] and local[p][0][1] in where:
                heapq.heappop(local[p])
            best = None
            if local[p]:
                c = local[p][0][1]
                best = (g.clevel[c] - _LOAD_PENALTY * missing(c, p), -c, c, "local")
            looked = []
            while pool and len(looked) < 8:
                item = heapq.heappop(pool)
                if item[1] not in where:
                    looked.append(item)
            for _, c in looked:
                key = (g.clevel[c] - _LOAD_PENALTY * missing(c, p), -c, c, "pool")
                if best is None or key > best:
                    best = key
            for item in looked:
                if best is None or item[1] != best[2] or best[3] != "pool":
                    heapq.heappush(pool, item)
            if best is None:
                idle[p] = True
                continue
            c = best[2]
            if best[3] == "local":
                heapq.heappop(local[p])
            load[p] += g.ccost[c] + _EXCHANGE * missing(c, p)
            where[c] = (phase, p)
            held[p].update(g.ext[c])
            held[p].update(g.members[c])
            for u in g.cusers[c]:
                remaining[u] -= 1
                if remaining[u] == 0:
                    now = {where[g.cluster[j]][1] for j in g.ext[u] if where[g.cluster[j]][0] == phase}
                    if now == {p}:
                        heapq.heappush(local[p], (-g.clevel[u], u))
                    else:
                        blocked.append(u)
        for p in range(parts):
            blocked += [c for _, c in local[p] if c not in where]
        for c in set(blocked):
            heapq.heappush(pool, (-g.clevel[c], c))
        if not any(where.get(c, (-1,))[0] == phase for c in g.members):
            raise RuntimeError("no cluster could be placed: the cluster graph has a cycle")
        phase += 1
    return where, phase


def _finish(g: _Graph, where, phases: int, parts: int, carried: int):
    """Recomputation, exchange slots and the estimate of one placement."""
    node_phase = [where[g.cluster[i]][0] for i in range(g.n)]
    node_part = [where[g.cluster[i]][1] for i in range(g.n)]
    computed = [dict() for _ in range(parts)]  # node -> phase, per partition
    for i in range(g.n):
        computed[node_part[i]][i] = node_phase[i]
    need: dict = {}  # (node, partition) -> first phase the partition reads it
    for i in range(g.n):
        q, k = node_part[i], node_phase[i]
        for j in g.preds[i]:
            if node_part[j] != q:
                need[(j, q)] = min(need.get((j, q), phases), k)
    recomputed = []
    changed = True
    while changed:
        changed = False
        for (j, q), k in sorted(need.items()):
            if (j, q) not in need or g.body[j].kind not in _CHEAP:
                continue
            if all(computed[q].get(x, phases) <= k or need.get((x, q), phases) <= k for x in g.preds[j]):
                del need[(j, q)]
                computed[q][j] = k
                recomputed.append((j, q, k))
                changed = True
    # a slot is free again after the last phase that reads it
    last_read = collections.defaultdict(int)
    for (j, q), k in need.items():
        last_read[j] = max(last_read[j], k)
    slot_of: dict = {}
    free: list = []
    busy: list = []  # (last read phase, slot)
    top = carried
    for j in sorted(last_read, key=lambda x: (node_phase[x], x)):
        w = node_phase[j]
        while busy and busy[0][0] < w:
            heapq.heappush(free, heapq.heappop(busy)[1])
        if free:
            s = heapq.heappop(free)
        else:
            s, top = top, top + 1
        slot_of[j] = s
        heapq.heappush(busy, (last_read[j], s))
    seg = [[0] * parts for _ in range(phases)]
    issue = [[0] * parts for _ in range(phases)]
    moved = [[0] * parts for _ in range(phases)]
    for p in range(parts):
        for i, k in computed[p].items():
            seg[k][p] += g.cost[i]
            issue[k][p] += 1
    for (j, q), k in need.items():
        seg[k][q] += _EXCHANGE
        issue[k][q] += 1
        moved[k][q] += 1
    for j in slot_of:
        seg[node_phase[j]][node_part[j]] += _EXCHANGE
        issue[node_phase[j]][node_part[j]] += 1
        moved[node_phase[j]][node_part[j]] += 1
    estimate = sum(max(s) for s in seg) + _BARRIER * phases
    return node_phase, node_part, computed, need, recomputed, slot_of, seg, issue, moved, top, estimate


def partition(body, parts: int, carried: int) -> WarpPartition:
    """Place the live body nodes (creation order, no loop nodes) of one
    substep on ``parts`` warps; ``carried`` slots are kept for the values
    carried between substeps. The placement of least estimate wins, the
    fewest slots on a tie, among those whose slots fit one group in a block
    (:data:`ONE_GROUP_SLOTS`) if any does."""
    if parts < 1:
        raise ValueError(f"parts must be at least 1, got {parts}")
    if any(n.kind in ("loop", "sincos") for n in body):
        raise ValueError("the warp partition takes straight-line statements only")
    g = _Graph(body)
    total = sum(g.cost)
    best = None
    for fraction in _BUDGET_FRACTIONS if parts > 1 else (1.0,):
        where, phases = _place(g, parts, max(total / parts * fraction, 1.0))
        result = _finish(g, where, phases, parts, carried)
        key = (result[-2] > ONE_GROUP_SLOTS, result[-1], result[-2])  # fits, estimate, slots
        if best is None or key < best[0]:
            best = (key, phases, result)
    _, phases, (node_phase, node_part, computed, need, recomputed, slot_of, seg, issue, moved, slots, estimate) = best
    blocks = [[[] for _ in range(parts)] for _ in range(phases)]
    for p in range(parts):
        for i, k in sorted(computed[p].items()):
            blocks[k][p].append(body[i])
    loads = [[[] for _ in range(parts)] for _ in range(phases)]
    for (j, q), k in sorted(need.items()):
        loads[k][q].append((body[j], slot_of[j]))
    stores = [[[] for _ in range(parts)] for _ in range(phases)]
    for j in sorted(slot_of):
        stores[node_phase[j]][node_part[j]].append((body[j], slot_of[j]))
    return WarpPartition(
        parts=parts,
        phases=phases,
        blocks=blocks,
        loads=loads,
        stores=stores,
        owner={body[i].id: node_part[i] for i in range(g.n)},
        recomputed=[(body[j], q, k) for j, q, k in recomputed],
        slots=slots,
        carried=carried,
        estimate=estimate,
        segments=seg,
        issues=issue,
        moved=moved,
        live=_live(blocks, loads, parts, phases),
    )


def _live(blocks, loads, parts: int, phases: int) -> list:
    """``live[p]``: the most values partition p holds in registers across a
    phase boundary (computed or loaded before it, read at or after it); with
    one phase (one thread an env), the most values live at once in emission
    order."""
    live = [0] * parts
    for p in range(parts):
        if phases == 1:  # positions in emission order stand for phases
            enter = {n.id: i for i, n in enumerate(blocks[0][p])}
            last = {a.id: i for i, n in enumerate(blocks[0][p]) for a in n.args}
            steps = len(blocks[0][p])
        else:
            enter, last = {}, {}
            for k in range(phases):
                for n, _ in loads[k][p]:
                    enter[n.id] = k
                for n in blocks[k][p]:
                    enter.setdefault(n.id, k)
                    last.update(dict.fromkeys((a.id for a in n.args), k))
            steps = phases
        crossing = [0] * (steps + 1)
        for i, k in enter.items():
            if i in last and last[i] > k:
                crossing[k + 1] += 1
                crossing[last[i] + 1] -= 1
        run = 0
        for k in range(steps):
            run += crossing[k]
            live[p] = max(live[p], run)
    return live


# ---------------------------------------------------------------------------
# The layout model: clocks of a call for a placement, ``groups`` groups of 32
# envs a block. Each SM walks its phases at the pace of the slower of its
# warps' own chains (the schedule's segments, scaled) and its four
# schedulers' issue; a phase ends at the group's named barrier; and what an
# SM fetches from L2 each substep (its code past the instruction cache, the
# values its threads spill) comes at the L2's rate shared by the busy SMs.
# Waves of blocks run one after another. The card's limits are the H100's;
# the fitted constants are those of ``tools/port_articulated_fit.py`` over
# the probe's sweeps (PERF.md).

SMS = 132
SCHEDULERS = 4  # warp schedulers an SM, each issuing one instruction a clock
WARPS_SM = 64
SHARED_SM = 233_472  # shared memory of an SM, of which one block may have SHARED_BYTES_MAX
REGISTERS_SM = 65_536
SASS_BYTES = 16
SASS_PER_STATEMENT = 1.3  # SASS instructions an emitted statement, load or store takes (the HalfCheetah and Ant builds)
#: The constants ``tools/port_articulated_fit.py`` fitted to three of the
#: probe's sweeps on an H100, in sample: no held-out check (PERF.md).
#: ``spill_live_one`` was set by hand (one thread an env spills above about
#: 360 live values: Pusher, Ant).
MODEL = {
    "issue_scale": 3.69,  # clocks a scheduler takes for one instruction of each warp it holds
    "latency_scale": 1.36,  # real clocks a schedule clock of one warp's chain takes
    "block_barrier": 99.075,  # clocks a group's named barrier adds a phase ...
    "barrier_warp": 0.01,  # ... and for each warp it holds
    "exchange": 7.742,  # clocks each load or store adds to its warp's chain beyond the schedule's
    "spill_live": 388.433,  # values a thread holds across phases (carried ones too) before it spills
    "spill_live_one": 360.0,  # the same, one thread an env (its live values counted in emission order)
    "spill_bytes": 1249.791,  # L2 bytes a substep each value past those costs a warp
    "icache_bytes": 41311.837,  # code an SM runs without fetching all of it again each substep
    "warm_fetch": 0.01,  # the share of its code an SM fetches again each substep when the code fits
    "l2_sms": 29.006,  # SMs that take all of the L2's rate between them; fewer get as much each
    "l2_rate": 2492.298,  # L2 bytes a clock all the SMs get together
}


def layout_clocks(wp: WarpPartition, groups: int, envs: int, substeps: int = 1, model: dict | None = None) -> dict:
    """The layout model's clocks of one call at ``envs`` envs (``model``
    overrides :data:`MODEL`), with its parts: waves of blocks, blocks an SM,
    busy SMs, code bytes, L2 and phase clocks a substep."""
    c = {**MODEL, **(model or {})}
    warps = wp.parts * groups
    shared = wp.shared_bytes(groups)
    # ptxas keeps a thread within 65,536 registers over the block's threads
    # (__launch_bounds__), at most 255: a smaller budget spills sooner
    cap = min(255, REGISTERS_SM // (32 * warps) // 8 * 8)
    threshold = (c["spill_live"] if wp.phases > 1 else c["spill_live_one"]) * cap / 255
    excess = np.maximum(0.0, np.asarray(wp.live, dtype=np.float64) + wp.carried - threshold)
    registers = min(255, 32 + max(wp.live) + wp.carried)
    resident = max(1, min(SHARED_SM // (shared + 1024) if shared else 32, WARPS_SM // warps,
                          REGISTERS_SM // (registers * 32 * warps)))
    # the card spreads blocks over its SMs before it stacks them on one
    blocks = -(-(-(-envs // 32)) // groups)
    waves = -(-blocks // (SMS * resident))
    busy_sms = min(SMS, blocks)
    stacked = groups * min(resident, -(-blocks // SMS))  # groups an SM runs at once
    seg, moved, issues = (np.asarray(x, dtype=np.float64) for x in (wp.segments, wp.moved, wp.issues))
    chain = c["latency_scale"] * seg + c["exchange"] * moved
    latency = chain.max(axis=1) + c["block_barrier"] + c["barrier_warp"] * wp.parts
    slots = c["issue_scale"] * stacked * issues.sum(axis=1) / min(SCHEDULERS, wp.parts * stacked)
    phase_clocks = float(np.maximum(latency, slots).sum())
    code = float(SASS_BYTES * SASS_PER_STATEMENT * issues.sum())
    spilled = c["spill_bytes"] * stacked * float(excess.sum())
    fetched = code * (1.0 if code > c["icache_bytes"] else c["warm_fetch"]) + spilled
    l2_clocks = fetched / (c["l2_rate"] / max(busy_sms, c["l2_sms"]))
    return {"clocks": waves * substeps * (phase_clocks + l2_clocks), "waves": waves, "resident_blocks": resident,
            "busy_sms": busy_sms, "code_bytes": int(code), "l2_clocks": l2_clocks, "phase_clocks": phase_clocks}


def unit_shape(nodes) -> tuple:
    """The shape of a unit's statement nodes: each node's kind, type and
    operands, an operand being the position of a node of the same unit or
    just its type. Units of one shape run the same instructions."""
    pos = {n.id: i for i, n in enumerate(nodes)}

    def arg(a):
        a_id = a.args[0].id if a.kind == "part" else a.id
        if a_id in pos:
            return ("i", pos[a_id], a.value if a.kind == "part" else None)
        return ("x", a.dtype)

    return tuple((n.kind, n.dtype, tuple(arg(a) for a in n.args)) for n in nodes)


def lane_schedule(units: dict, lane_of: dict) -> list[dict]:
    """Phases of one straight-line block: ``units`` maps each unit tag to its
    statement nodes in the block (in order), ``lane_of`` each tag to its
    lane. Returns ``[{lane: tag}, ...]``: a unit runs after every unit that
    computes a value it reads (a node outside its own list, made by
    ``node.unit``), and the units of a phase share a shape and a lane each.
    Among the ready units the one with the longest path of latencies to the
    block's end picks the phase's shape."""
    owned = {t: {n.id for n in nodes} for t, nodes in units.items()}
    block = set().union(*owned.values()) if owned else set()
    preds = {}
    for t, nodes in units.items():
        ps = set()
        for n in nodes:
            for a in n.args:
                a = a.args[0] if a.kind == "part" else a
                if a.id in block and a.id not in owned[t]:
                    if a.unit not in units or a.id not in owned[a.unit]:
                        raise ValueError(f"node t{a.id} of this block belongs to no unit that computes it")
                    ps.add(a.unit)
        preds[t] = ps
    order = {t: i for i, t in enumerate(units)}
    users = collections.defaultdict(set)
    for t, ps in preds.items():
        for p in ps:
            users[p].add(t)
    cost = {t: sum(LATENCY[n.kind] for n in nodes) for t, nodes in units.items()}
    level: dict = {}

    def path(t, seen=()):
        if t not in level:
            if t in seen:
                raise ValueError(f"units {seen} depend on each other in a cycle")
            level[t] = cost[t] + max((path(u, seen + (t,)) for u in users[t]), default=0)
        return level[t]

    for t in units:
        path(t)
    shapes = {t: unit_shape(nodes) for t, nodes in units.items()}
    placed, phases = set(), []
    while len(placed) < len(units):
        ready = sorted((t for t in units if t not in placed and preds[t] <= placed),
                       key=lambda t: (-level[t], order[t]))
        if not ready:
            raise ValueError("units depend on each other in a cycle")
        phase = {}
        for t in ready:
            if shapes[t] == shapes[ready[0]] and lane_of[t] not in phase:
                phase[lane_of[t]] = t
        placed.update(phase.values())
        phases.append(dict(sorted(phase.items())))
    return phases
