"""The model zoo (port of :mod:`repro.models`), plain functions over
plain-dict parameters: the LM transformers (``layers``, ``blockwise``,
``attention`` (GQA and MLA), ``moe`` and ``transformer``), whose GQA decode
attention runs the ``decode_attention`` kernel and whose MoE router runs
the ``topk`` kernel on the card; the recsys models (``embedding``:
EmbeddingBag and the fused multi-table lookup; ``recsys``: DLRM, DeepFM,
MIND and BERT4Rec); and the GAT (``gnn``, with its host neighbour
sampler).  The recsys models and the GAT run no kernel of their own."""
