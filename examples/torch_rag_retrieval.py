"""RAG-style integration on the PyTorch port: an LM of the port's model zoo
produces document embeddings; MCGI indexes them; queries retrieve context.

The encoder is the qwen2-7b *smoke* config (mean-pooled hidden states) with
weights drawn from ``--seed`` (the repository holds no checkpoint), so the
example runs in seconds.

Two retrieval modes over the same index:

* open retrieval: the plain beam walk; the quality signal is the topic
  purity of the retrieved context (how often the ANN result is on-topic);
* namespace-scoped retrieval: each query carries an *allowed* mask for its
  own topic (the multi-tenant RAG shape).  The mask is enforced in-graph
  (:func:`repro_torch.core.search.pack_filter` pre-seeds the walk's
  visited bitset), so out-of-namespace documents are never expanded,
  ranked or returned; the number to read is recall against the
  within-namespace ground truth.

    PYTHONPATH=src python examples/torch_rag_retrieval.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import base as cfg_base
from repro_torch.core import BuildConfig, brute_force_topk, build_mcgi, recall_at_k
from repro_torch.core.search import beam_search_exact, pack_filter
from repro_torch.models import transformer as tfm


def embed_corpus(cfg, params, token_batches):
    """Mean-pooled final hidden states as unit-norm document embeddings."""
    outs = []
    with torch.no_grad():
        for tokens in token_batches:
            h, _ = tfm.forward(cfg, params, tokens)
            outs.append(h.mean(1))
    e = torch.cat(outs).float()
    return e / (torch.linalg.norm(e, dim=1, keepdim=True) + 1e-9)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--docs", type=int, default=2048)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = cfg_base.get("qwen2-7b").smoke_config
    params = tfm.init_lm(cfg, torch.Generator(device=dev).manual_seed(
        args.seed), device=dev)

    # Synthetic "documents": clustered token sequences (topics share a
    # unigram distribution, so embeddings cluster by topic).
    n_docs, seq, n_topics = args.docs, args.seq, 16
    rng = np.random.default_rng(args.seed)
    topic_vocab = rng.integers(0, cfg.vocab, size=(n_topics, 64))
    topics = rng.integers(0, n_topics, size=n_docs)
    docs = np.stack([topic_vocab[t][rng.integers(0, 64, size=seq)]
                     for t in topics]).astype(np.int64)

    batches = [torch.from_numpy(docs[i:i + 256]).to(dev)
               for i in range(0, n_docs, 256)]
    print(f"[rag] embedding {n_docs} docs with {cfg.name} on {dev}...")
    emb = embed_corpus(cfg, params, batches)

    print("[rag] building MCGI index over document embeddings...")
    index = build_mcgi(emb, BuildConfig(degree=16, beam_width=32, iters=1),
                       device=dev)

    # Queries: fresh docs from known topics; retrieval should return docs of
    # the same topic.
    q_topics = rng.integers(0, n_topics, size=64)
    q_docs = np.stack([topic_vocab[t][rng.integers(0, 64, size=seq)]
                       for t in q_topics]).astype(np.int64)
    q_emb = embed_corpus(cfg, params, [torch.from_numpy(q_docs).to(dev)])

    _, gt_ids = brute_force_topk(q_emb, emb, k=10)
    ids, _, stats = beam_search_exact(emb, index.adj, q_emb, index.entry,
                                      beam_width=32, k=10)
    r = float(recall_at_k(ids, gt_ids))

    # Topic purity of retrieved contexts (the RAG quality signal).
    retrieved_topics = topics[ids.cpu().numpy()]
    purity = float((retrieved_topics == q_topics[:, None]).mean())
    print(f"[rag] ANN recall@10 vs exact = {r:.4f} | topic purity of "
          f"retrieved context = {purity:.3f} | io/query="
          f"{float(stats.hops.float().mean()):.1f}")

    # Namespace-scoped retrieval: each query may only surface its own
    # topic's documents, enforced in-graph via the packed filter.
    allowed = topics[None, :] == q_topics[:, None]           # (Q, n_docs)
    excl = pack_filter(allowed, n_docs, device=dev)
    f_ids, _, f_stats = beam_search_exact(emb, index.adj, q_emb, index.entry,
                                          beam_width=32, k=10, excl=excl)
    f_ids_np = f_ids.cpu().numpy()
    in_ns = allowed[np.arange(q_emb.shape[0])[:, None],
                    np.maximum(f_ids_np, 0)] | (f_ids_np < 0)
    assert in_ns.all(), "in-graph filter leaked out-of-namespace documents"
    qn, en = q_emb.cpu().numpy(), emb.cpu().numpy()
    d2 = np.einsum("qnd,qnd->qn", qn[:, None] - en[None], qn[:, None] - en[None],
                   dtype=np.float32)
    d2[~allowed] = np.inf
    gt_ns = np.argsort(d2, axis=1, kind="stable")[:, :10]
    r_ns = float(recall_at_k(f_ids, torch.from_numpy(gt_ns).to(dev)))
    print(f"[rag] namespace-scoped: recall@10 vs within-namespace exact = "
          f"{r_ns:.4f} | out-of-namespace results = 0 (in-graph mask) | "
          f"io/query={float(f_stats.hops.float().mean()):.1f}")
    return {"recall": r, "purity": purity, "recall_namespace": r_ns}


if __name__ == "__main__":
    main()
