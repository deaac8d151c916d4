"""gat-cora [arXiv:1710.10903]: 2-layer GAT, d_hidden=8, 8 heads, attn
aggregator (the port's copy of ``repro/configs/gat_cora.py``).  Four graph
regimes with their published stats:

  * full_graph_sm : Cora        (2,708 nodes / 10,556 edges / 1,433 feats / 7 cls)
  * minibatch_lg  : Reddit      (232,965 / 114,615,892 / 602 feats / 41 cls),
                    sampled 1024-node batches, fanout 15-10
  * ogb_products  : ogbn-products (2,449,029 / 61,859,140 / 100 feats / 47 cls)
  * molecule      : 128-graph batches of <=30-node molecules (graph-level task)

The GAT layer config is fixed; per-regime input dims / classes follow the
named datasets.
"""
import dataclasses

from repro_torch.configs import base
from repro_torch.models.gnn import GatConfig


@dataclasses.dataclass(frozen=True)
class GatArchConfig:
    """Per-regime GAT instantiations share the layer hyper-parameters."""

    d_hidden: int = 8
    n_heads: int = 8

    def for_regime(self, d_in: int, n_classes: int) -> GatConfig:
        return GatConfig(
            d_in=d_in, d_hidden=self.d_hidden, n_heads=self.n_heads,
            n_classes=n_classes, n_layers=2,
        )


CONFIG = GatArchConfig()
SMOKE_CONFIG = GatArchConfig(d_hidden=4, n_heads=2)

# Sampled-block padding for minibatch_lg: 1024 seeds, fanout (15, 10) =>
# <= 1024*(1 + 15 + 150) nodes and <= 1024*15 + 15360*10 edges; padded to
# static shapes.
_MB_NODES = base.pad_to(1024 * (1 + 15 + 150), 256)      # 169,984
_MB_EDGES = base.pad_to(1024 * 15 + 1024 * 15 * 10, 256)  # 168,960

SHAPES = (
    base.ShapeCell(
        "full_graph_sm", base.GNN_TRAIN,
        {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433, "n_classes": 7,
         "level": "node"},
    ),
    base.ShapeCell(
        "minibatch_lg", base.GNN_TRAIN,
        {"n_nodes": _MB_NODES, "n_edges": _MB_EDGES, "d_feat": 602,
         "n_classes": 41, "level": "node", "batch_nodes": 1024,
         "fanout": (15, 10), "full_graph_nodes": 232965,
         "full_graph_edges": 114615892},
        note="Reddit; dry-run lowers the per-block train step at the padded "
             "sampler output shapes; the sampler itself is host-side "
             "(models/gnn.py::NeighborSampler).",
    ),
    base.ShapeCell(
        "ogb_products", base.GNN_TRAIN,
        {"n_nodes": 2449029, "n_edges": 61859140, "d_feat": 100,
         "n_classes": 47, "level": "node"},
    ),
    base.ShapeCell(
        "molecule", base.GNN_TRAIN,
        {"n_nodes": 30, "n_edges": 64, "batch_graphs": 128, "d_feat": 32,
         "n_classes": 2, "level": "graph"},
        note="128 molecules batched block-diagonally: 3,840 nodes / 8,192 "
             "edges per step, mean-pooled graph readout.",
    ),
)

SPEC = base.register(
    base.ArchSpec(
        arch_id="gat-cora",
        family="gnn",
        config=CONFIG,
        smoke_config=SMOKE_CONFIG,
        shapes=SHAPES,
        source="arXiv:1710.10903",
    )
)
