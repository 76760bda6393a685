"""Graph space: dynamically sized graphs with node and edge features.

Copy of the JAX package's ``spaces/graph.py``, which follows Gymnasium's
(``GraphInstance(nodes, edges, edge_links)``; Box or Discrete node/edge
feature spaces). Host-side only — dynamic node/edge counts do not map to
fixed device shapes.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Sequence, Union

import numpy as np

import gymnasium_tpu_torch.logger as logger

from gymnasium_tpu_torch.spaces.box import Box
from gymnasium_tpu_torch.spaces.discrete import Discrete
from gymnasium_tpu_torch.spaces.multi_discrete import MultiDiscrete
from gymnasium_tpu_torch.spaces.space import Space


class GraphInstance(NamedTuple):
    """A graph sample: node features, optional edge features, and edge links."""

    nodes: np.ndarray
    edges: np.ndarray | None
    edge_links: np.ndarray | None


class Graph(Space[GraphInstance]):
    """Graphs with ``node_space`` features per node and optional ``edge_space``."""

    def __init__(
        self,
        node_space: Box | Discrete,
        edge_space: None | Box | Discrete,
        seed: int | np.random.Generator | None = None,
    ):
        assert isinstance(node_space, (Box, Discrete)), (
            f"Values of the node_space should be instances of Box or Discrete, got {type(node_space)}"
        )
        if edge_space is not None:
            assert isinstance(edge_space, (Box, Discrete)), (
                f"Values of the edge_space should be instances of None Box or Discrete, got {type(edge_space)}"
            )
        self.node_space = node_space
        self.edge_space = edge_space
        super().__init__(None, None, seed)  # type: ignore[arg-type]

    def seed(
        self, seed: int | tuple[int, ...] | None = None
    ) -> tuple[int, ...]:
        """Seed the graph, node, and edge PRNGs (reference graph.py:109-177):
        ``None`` seeds all randomly, an int derives sub-seeds (re-seeding so
        the graph PRNG state matches tuple seeding), a tuple seeds each."""
        if seed is None:
            if self.edge_space is None:
                return super().seed(None), self.node_space.seed(None)
            return (
                super().seed(None),
                self.node_space.seed(None),
                self.edge_space.seed(None),
            )
        if isinstance(seed, int):
            super_seed = super().seed(seed)
            if self.edge_space is None:
                node_seed = int(self.np_random.integers(np.iinfo(np.int32).max))
                super().seed(seed)
                return super_seed, self.node_space.seed(node_seed)
            node_seed, edge_seed = self.np_random.integers(
                np.iinfo(np.int32).max, size=(2,)
            )
            super().seed(seed)
            return (
                super_seed,
                self.node_space.seed(int(node_seed)),
                self.edge_space.seed(int(edge_seed)),
            )
        if isinstance(seed, (list, tuple)):
            if self.edge_space is None:
                if len(seed) != 2:
                    raise ValueError(
                        f"Expects a tuple of two values for Graph and node space, actual length: {len(seed)}"
                    )
                return super().seed(seed[0]), self.node_space.seed(seed[1])
            if len(seed) != 3:
                raise ValueError(
                    f"Expects a tuple of three values for Graph, node and edge space, actual length: {len(seed)}"
                )
            return (
                super().seed(seed[0]),
                self.node_space.seed(seed[1]),
                self.edge_space.seed(seed[2]),
            )
        raise TypeError(
            f"Expects `None`, int or tuple of ints, actual type: {type(seed)}"
        )

    @property
    def is_np_flattenable(self) -> bool:
        return False

    def _generate_sample_space(self, base_space, num_elements: int) -> Box | MultiDiscrete | None:
        if num_elements == 0 or base_space is None:
            return None
        if isinstance(base_space, Box):
            return Box(
                low=np.array(max(1, num_elements) * [base_space.low]),
                high=np.array(max(1, num_elements) * [base_space.high]),
                shape=(num_elements,) + base_space.shape,
                dtype=base_space.dtype,
                seed=self.np_random,
            )
        if isinstance(base_space, Discrete):
            return MultiDiscrete(
                nvec=[base_space.n] * num_elements, seed=self.np_random
            )
        raise TypeError(f"Expects base space to be Box and Discrete, actual space: {type(base_space)}")

    def sample(
        self,
        mask: None | tuple[Any, Any] = None,
        probability: None | tuple[Any, Any] = None,
        num_nodes: int = 10,
        num_edges: int | None = None,
    ) -> GraphInstance:
        """Sample a graph with ``num_nodes`` nodes and random edge structure
        (semantics and messages per reference graph.py:186-271)."""
        assert num_nodes > 0, f"The number of nodes is expected to be greater than 0, actual value: {num_nodes}"
        if mask is not None and probability is not None:
            raise ValueError(
                f"Only one of `mask` or `probability` can be provided, actual values: mask={mask}, probability={probability}"
            )
        use_probability = probability is not None
        chosen = probability if use_probability else mask
        node_mask, edge_mask = (None, None) if chosen is None else chosen

        # we only have edges when we have at least 2 nodes
        if num_edges is None:
            if num_nodes > 1:
                # max edges is n*(n-1): self connections and two-way allowed
                num_edges = int(self.np_random.integers(num_nodes * (num_nodes - 1)))
            else:
                num_edges = 0
            if edge_mask is not None:
                edge_mask = tuple(edge_mask for _ in range(num_edges))
        else:
            if self.edge_space is None:
                logger.warn(
                    f"The number of edges is set ({num_edges}) but the edge space is None."
                )
            assert num_edges >= 0, (
                f"Expects the number of edges to be greater than 0, actual value: {num_edges}"
            )
        num_edges = int(num_edges)

        node_sample_space = self._generate_sample_space(self.node_space, num_nodes)
        edge_sample_space = self._generate_sample_space(self.edge_space, num_edges)

        assert node_sample_space is not None
        kw = "probability" if use_probability else "mask"
        sampled_nodes = node_sample_space.sample(**{kw: node_mask})
        sampled_edges = (
            edge_sample_space.sample(**{kw: edge_mask}) if edge_sample_space is not None else None
        )

        sampled_edge_links = None
        if sampled_edges is not None and num_edges > 0:
            sampled_edge_links = self.np_random.integers(
                low=0, high=num_nodes, size=(num_edges, 2), dtype=np.int32
            )

        return GraphInstance(sampled_nodes, sampled_edges, sampled_edge_links)

    def contains(self, x: Any) -> bool:
        """Membership per reference graph.py:273-298: edges and edge_links
        must be present together and consistent; both-absent is valid even
        when an edge space exists."""
        if not isinstance(x, GraphInstance):
            return False
        if not isinstance(x.nodes, np.ndarray):
            return False
        if not all(node in self.node_space for node in x.nodes):
            return False
        if isinstance(x.edges, np.ndarray) and isinstance(x.edge_links, np.ndarray):
            if self.edge_space is None:
                return False
            if not all(edge in self.edge_space for edge in x.edges):
                return False
            if not np.issubdtype(x.edge_links.dtype, np.integer):
                return False
            if x.edge_links.shape != (len(x.edges), 2):
                return False
            return bool(np.all((x.edge_links >= 0) & (x.edge_links < len(x.nodes))))
        return x.edges is None and x.edge_links is None

    def __repr__(self) -> str:
        return f"Graph({self.node_space}, {self.edge_space})"

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, Graph)
            and self.node_space == other.node_space
            and self.edge_space == other.edge_space
        )

    def to_jsonable(self, sample_n: Sequence[GraphInstance]) -> list[dict[str, Any]]:
        out = []
        for sample in sample_n:
            json_dict: dict[str, Any] = {"nodes": sample.nodes.tolist()}
            if sample.edges is not None and sample.edge_links is not None:
                json_dict["edges"] = sample.edges.tolist()
                json_dict["edge_links"] = sample.edge_links.tolist()
            out.append(json_dict)
        return out

    def from_jsonable(self, sample_n: Sequence[dict[str, Any]]) -> list[GraphInstance]:
        out = []
        for sample in sample_n:
            if "edges" in sample:
                assert self.edge_space is not None
                out.append(
                    GraphInstance(
                        np.asarray(sample["nodes"], dtype=self.node_space.dtype),
                        np.asarray(sample["edges"], dtype=self.edge_space.dtype),
                        np.asarray(sample["edge_links"], dtype=np.int32),
                    )
                )
            else:
                out.append(
                    GraphInstance(
                        np.asarray(sample["nodes"], dtype=self.node_space.dtype), None, None
                    )
                )
        return out
