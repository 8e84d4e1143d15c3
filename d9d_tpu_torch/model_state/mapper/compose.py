"""Compose mappers: parallel union, sequential pipeline, prefix scoping,
group sharding (counterpart of ``d9d_tpu/model_state/mapper/compose.py``,
the same machinery: tensors pass through untouched).

The sequential composition is built around a static carry plan: at
construction it computes, per stage boundary, which keys must flow past
the stage untouched (needed downstream but not produced in between, or
produced earlier and never consumed again), and ``apply`` consults that
plan at run time. Net dependency groups come from a union-find over the
key graph (``_KeyComponents``), which merges transitively: stage A
``{x}→{y}`` then stage B ``{y}→{z}`` is one net group ``{x}→{z}``.
"""

from collections.abc import Iterable, Sequence

from d9d_tpu_torch.model_state.mapper.abc import (
    ModelStateMapper,
    StateDict,
    StateGroup,
)


def _union(sets: Iterable[frozenset[str]]) -> frozenset[str]:
    out: set[str] = set()
    for s in sets:
        out |= s
    return frozenset(out)


def _stage_io(mapper: ModelStateMapper) -> tuple[frozenset[str], frozenset[str]]:
    groups = mapper.state_dependency_groups()
    return _union(g.inputs for g in groups), _union(g.outputs for g in groups)


def filter_empty_mappers(
    mappers: Sequence[ModelStateMapper],
) -> list[ModelStateMapper]:
    """Drop mappers whose every dependency group is empty."""
    return [
        m
        for m in mappers
        if any(g.inputs or g.outputs for g in m.state_dependency_groups())
    ]


class _KeyComponents:
    """Union-find over state keys; one component per connected transform."""

    def __init__(self) -> None:
        self._parent: dict[str, str] = {}

    def _root(self, key: str) -> str:
        parent = self._parent.setdefault(key, key)
        if parent == key:
            return key
        root = self._root(parent)
        self._parent[key] = root
        return root

    def connect(self, keys: Iterable[str]) -> None:
        it = iter(keys)
        first = next(it, None)
        if first is None:
            return
        anchor = self._root(first)
        for key in it:
            self._parent[self._root(key)] = anchor

    def components(self) -> dict[str, set[str]]:
        out: dict[str, set[str]] = {}
        for key in list(self._parent):
            out.setdefault(self._root(key), set()).add(key)
        return out


class ModelStateMapperParallel(ModelStateMapper):
    """Side-by-side union of independent mappers.

    Every sub-mapper keeps exclusive ownership of its input and output
    keys; overlap is a construction-time error. ``apply`` dispatches a
    complete input group to whichever sub-mapper declared it.
    """

    def __init__(self, mappers: Sequence[ModelStateMapper]):
        members = filter_empty_mappers(mappers)
        self._route: dict[frozenset[str], ModelStateMapper] = {}
        claimed_in: set[str] = set()
        claimed_out: set[str] = set()
        for member in members:
            for g in member.state_dependency_groups():
                overlap_in = claimed_in & g.inputs
                if overlap_in:
                    raise ValueError(
                        f"parallel mapper: input keys {sorted(overlap_in)} "
                        "claimed by more than one sub-mapper"
                    )
                overlap_out = claimed_out & g.outputs
                if overlap_out:
                    raise ValueError(
                        f"parallel mapper: output keys {sorted(overlap_out)} "
                        "produced by more than one sub-mapper"
                    )
                claimed_in |= g.inputs
                claimed_out |= g.outputs
                self._route[g.inputs] = member
        self._groups = frozenset(
            g for m in members for g in m.state_dependency_groups()
        )

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return self._groups

    def apply(self, group: StateDict) -> StateDict:
        member = self._route.get(frozenset(group))
        if member is None:
            raise ValueError(
                f"parallel mapper: keys {sorted(group)} do not form a "
                "declared dependency group (groups must be applied whole)"
            )
        return member.apply(group)


class ModelStateMapperSequential(ModelStateMapper):
    """Pipeline of mappers with automatic key pass-through.

    Keys a later stage needs that an earlier stage does not produce flow
    through untouched; keys produced mid-pipeline and never consumed again
    flow to the output. Net dependency groups are transitively merged
    across stages.
    """

    def __init__(self, mappers: list[ModelStateMapper]):
        stages = filter_empty_mappers(mappers)
        if not stages:
            raise ValueError(
                "sequential mapper needs at least one stage with a "
                "non-empty dependency group"
            )
        self._stages = stages
        io = [_stage_io(m) for m in stages]

        # needed[i] = keys stages i..end must see entering stage i
        needed: list[frozenset[str]] = [frozenset()] * (len(stages) + 1)
        for i in reversed(range(len(stages))):
            ins, outs = io[i]
            needed[i] = ins | (needed[i + 1] - outs)

        # keys that must pass over stage i untouched; consuming one of them
        # at stage i would leave downstream starved — reject at build time
        self._carry: list[frozenset[str]] = []
        for i, (ins, outs) in enumerate(io):
            over = needed[i + 1] - outs
            stuck = over & ins
            if stuck:
                raise ValueError(
                    f"sequential mapper: keys {sorted(stuck)} are consumed "
                    f"by stage {i} but later stages still need them and no "
                    "stage in between re-produces them"
                )
            self._carry.append(over)

        self._net_inputs = needed[0]
        self._groups = self._compute_net_groups(io)

    def _compute_net_groups(self, io) -> frozenset[StateGroup]:
        # simulate key flow to find the final key set
        live = set(self._net_inputs)
        made: set[str] = set()
        for i, stage in enumerate(self._stages):
            nxt: set[str] = set()
            used: set[str] = set()
            for g in stage.state_dependency_groups():
                if g.inputs <= live:
                    nxt |= g.outputs
                    made |= g.outputs
                    used |= g.inputs
            for key in live - used:
                if key in self._carry[i] or key in made:
                    nxt.add(key)
            live = nxt
        net_outputs = frozenset(live)

        comps = _KeyComponents()
        for stage in self._stages:
            for g in stage.state_dependency_groups():
                comps.connect(g.inputs | g.outputs)
        groups = []
        for keys in comps.components().values():
            ins = frozenset(keys) & self._net_inputs
            outs = frozenset(keys) & net_outputs
            if ins or outs:
                groups.append(StateGroup(inputs=ins, outputs=outs))
        return frozenset(groups)

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return self._groups

    def apply(self, group: StateDict) -> StateDict:
        state = dict(group)
        made: set[str] = set()
        for i, stage in enumerate(self._stages):
            nxt: StateDict = {}
            used: set[str] = set()
            for g in stage.state_dependency_groups():
                if g.inputs <= state.keys():
                    nxt.update(
                        stage.apply({k: state[k] for k in g.inputs})
                    )
                    made.update(g.outputs)
                    used |= g.inputs
            for key, value in state.items():
                if key not in used and (key in self._carry[i] or key in made):
                    nxt.setdefault(key, value)
            state = nxt
        return state


class ModelStateMapperPrefixScope(ModelStateMapper):
    """Run a child mapper under source/target key-name prefixes."""

    def __init__(
        self,
        mapper: ModelStateMapper,
        source_prefix: str = "",
        target_prefix: str = "",
    ):
        self._child = mapper
        self._src = source_prefix
        self._dst = target_prefix

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return frozenset(
            StateGroup(
                inputs=frozenset(self._src + k for k in g.inputs),
                outputs=frozenset(self._dst + k for k in g.outputs),
            )
            for g in self._child.state_dependency_groups()
        )

    def apply(self, group: StateDict) -> StateDict:
        inner = self._child.apply(
            {k.removeprefix(self._src): v for k, v in group.items()}
        )
        return {self._dst + k: v for k, v in inner.items()}


class ModelStateMapperShard(ModelStateMapper):
    """Round-robin a mapper's dependency groups across ``total_shards``
    workers — splits checkpoint transformation work across processes."""

    def __init__(
        self,
        sub_mapper: ModelStateMapper,
        total_shards: int,
        current_shard: int,
    ):
        ordered = sorted(
            sub_mapper.state_dependency_groups(),
            key=lambda g: sorted(g.inputs),
        )
        self._mine = frozenset(
            ordered[i] for i in range(current_shard, len(ordered), total_shards)
        )
        self._child = sub_mapper

    def state_dependency_groups(self) -> frozenset[StateGroup]:
        return self._mine

    def apply(self, group: StateDict) -> StateDict:
        return self._child.apply(group)
