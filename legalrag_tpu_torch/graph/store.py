"""Law-graph store: load + bounded BFS walk (port of
``legalrag_tpu/graph/store.py``, pure Python, the same file format).

Parity with reference ``LawGraphStore`` (``graph_store.py:29-169``): nodes
from JSONL, adjacency as (dst, relation, conf, evidence) tuples; ``walk``
is a BFS with *per-relation depth caps* — the allowance is checked against
the relation used to **reach** the frontier node — a visited set, a hard
unique-node limit, and cloned result nodes carrying query-time fields
(graph_depth / graph_parent / relations / edge evidence+conf in meta).

The walk stays on the host by design: graph expansion is pointer-chasing
over a small adjacency structure, the wrong shape for a GPU; the *scoring*
of walked candidates is one gather + product on the device
(``retrieval.channels.GraphRetriever``).
"""

from __future__ import annotations

import json
import dataclasses
from collections import deque
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

from legalrag_tpu_torch.schemas import LawNode, Neighbor
from legalrag_tpu_torch.utils import get_logger

log = get_logger("torch.graph.store")

Edge = Tuple[str, str, float, Optional[dict]]  # dst, relation, conf, evidence


class LawGraphStore:
    def __init__(self, graph_file: str | Path):
        self.path = Path(graph_file)
        self.nodes: Dict[str, LawNode] = {}
        self.adj: Dict[str, List[Edge]] = {}
        self._loaded = False
        self._mtime: float = -1.0

    # ------------------------------------------------------------------ load
    def load(self, force: bool = False) -> None:
        if not self.path.exists():
            if not self._loaded:
                raise FileNotFoundError(f"law graph not found: {self.path}")
            return
        mtime = self.path.stat().st_mtime
        if self._loaded and not force and mtime == self._mtime:
            return
        nodes: Dict[str, LawNode] = {}
        adj: Dict[str, List[Edge]] = {}
        n_edges = 0
        with self.path.open("r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                obj = json.loads(line)
                node = LawNode(
                    article_id=str(obj["article_id"]),
                    article_no=str(obj.get("article_no") or ""),
                    law_name=obj.get("law_name"),
                    title=obj.get("title"),
                    chapter=obj.get("chapter"),
                    section=obj.get("section"),
                    neighbors=[Neighbor(**nb) for nb in obj.get("neighbors", [])],
                    meta=obj.get("meta") or {},
                )
                nodes[node.article_id] = node
                adj[node.article_id] = [
                    (nb.article_id, nb.relation, nb.conf, nb.evidence)
                    for nb in node.neighbors
                ]
                n_edges += len(node.neighbors)
        self.nodes, self.adj = nodes, adj
        self._loaded, self._mtime = True, mtime
        log.info("loaded law graph: %d nodes, %d edges (%s)",
                 len(nodes), n_edges, self.path.name)

    # ------------------------------------------------------------------ walk
    def walk(self, start_ids: Sequence[str], limit: int = 800,
             relation_max_depth: Optional[Dict[str, int]] = None,
             rel_types: Optional[Sequence[str]] = None,
             min_conf: float = 0.0) -> List[LawNode]:
        self.load()
        start = [str(s).strip() for s in (start_ids or []) if str(s).strip()]
        if not start:
            return []
        depths = relation_max_depth or {"default": 2}
        default_depth = depths.get("default", 2)
        allow = set(rel_types) if rel_types else None
        limit = max(1, int(limit))

        visited = set(start)
        queue: deque[Tuple[str, int, Optional[str], Optional[str]]] = deque(
            (s, 0, None, None) for s in start)
        results: List[LawNode] = []

        while queue and len(results) < limit:
            cur, dist, _parent, rel = queue.popleft()
            # allowance keyed by the relation that *reached* this node
            max_allowed = depths.get(rel, default_depth) if rel else default_depth
            if dist >= max_allowed:
                continue
            for dst, rtype, conf, evidence in self.adj.get(cur, []):
                if min_conf > 0 and conf < min_conf:
                    continue
                if allow is not None and rtype not in allow:
                    continue
                if dst in visited:
                    continue
                visited.add(dst)
                base = self.nodes.get(dst)
                if base is None:
                    continue
                node = dataclasses.replace(base)  # shallow, as model_copy
                node.graph_depth = dist + 1
                node.graph_parent = cur
                node.relations = [rtype]
                node.meta = dict(node.meta or {})
                if evidence:
                    node.meta["_edge_evidence"] = evidence
                node.meta["_edge_conf"] = conf
                results.append(node)
                if len(results) >= limit:
                    break
                queue.append((dst, dist + 1, cur, rtype))
        return results

    def get_neighbors(self, article_id: str, depth: int = 1) -> List[LawNode]:
        self.load()
        aid = str(article_id).strip()
        if aid not in self.nodes:
            return []
        visited = {aid}
        frontier = [aid]
        out: List[LawNode] = []
        for _ in range(max(1, depth)):
            nxt: List[str] = []
            for cur in frontier:
                for dst, *_rest in self.adj.get(cur, []):
                    if dst in visited:
                        continue
                    visited.add(dst)
                    node = self.nodes.get(dst)
                    if node is not None:
                        out.append(node)
                        nxt.append(dst)
            frontier = nxt
        return out

    def get_node(self, article_id: str) -> Optional[LawNode]:
        self.load()
        return self.nodes.get(str(article_id).strip())
