"""The system under test for the in-memory tiered deployment: an MCGI graph
built by ``repro_torch.core.build.build_mcgi``, a PQ fast tier built by
``repro_torch.index.build_tiered_index``, served by
``repro_torch.serving.SearchEngine`` over a ``TieredBackend`` with the
adaptive budget law (probe, grant, continue, rerank from the full vectors).

Only the port's public entry points are called; every parameter comes from
the configuration's ``build``, ``pq`` and ``serve`` sections.  The build and
the PQ training take the configuration's ``build.seed``: a deployment
builds its index once and serves it, so every run serves the same index.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class System:
    engine: object
    build_timings: dict
    # The program's outputs that the checks judge, copied to the host.
    outputs: dict


def build(config: dict, x: torch.Tensor, device) -> System:
    from repro_torch import serving
    from repro_torch.core import build as build_mod
    from repro_torch.core.search import AdaptiveBeamBudget
    from repro_torch.index import build_tiered_index

    b, pq, s = config["build"], config["pq"], config["serve"]
    bcfg = build_mod.BuildConfig(
        degree=b["degree"], beam_width=b["l_build"], iters=b["iters"],
        lid_k=b["lid_k"], alpha_min=b["alpha_min"], alpha_max=b["alpha_max"],
        batch=b["batch"], max_hops=b["max_hops"],
        reverse_cap=b["reverse_cap"], seed=b["seed"])
    timings: dict = {}
    graph = build_mod.build_mcgi(x, bcfg, device=device, timings=timings)
    index = build_tiered_index(x, graph, m_pq=pq["m"], seed=b["seed"],
                               device=device)
    law = AdaptiveBeamBudget(
        l_min=s["l_min"], l_max=s["l_search"], lam=s["lam"],
        lid_k=s["lid_k"], probe_hops=s["probe_hops"],
        hop_factor=s["hop_factor"])
    engine = serving.SearchEngine(
        serving.TieredBackend(index, device=device), law, k=s["k"],
        max_hops=s["max_hops"])
    outputs = {
        "adj": graph.adj.cpu().numpy(),
        "entry": int(graph.entry),
        "codes": index.codes.cpu().numpy(),
        "centroids": index.codebook.centroids.cpu().numpy(),
    }
    return System(engine=engine, build_timings=timings, outputs=outputs)
