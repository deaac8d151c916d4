"""The graph built in set-up: unsound slots and rows of its adjacency (ids
out of range, self loops, repeats in a row, empty rows, a width other than
the configuration's degree) and an entry outside the graph
(:func:`bench.reference.graph.bad_entries`).  Exact: the limit is 0."""
import torch

from bench.reference import graph


def reading(ctx) -> float:
    adj = torch.as_tensor(ctx.outputs["adj"], device=ctx.x.device)
    if adj.shape[0] != ctx.x.shape[0]:
        return float(max(adj.shape[0], ctx.x.shape[0]))
    return graph.bad_entries(adj, ctx.outputs["entry"],
                             ctx.config["build"]["degree"])
