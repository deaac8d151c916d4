"""The LM zoo's serving path (port of :mod:`repro.models`: ``layers``,
``blockwise``, ``attention`` (GQA and MLA), ``moe`` and ``transformer``):
five architectures through one ``decode_step`` / ``prefill``, whose GQA
decode attention runs the ``decode_attention`` kernel and whose MoE router
runs the ``topk`` kernel on the card."""
