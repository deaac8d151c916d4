"""The dense-GQA language model of the reference's model zoo (port of
:mod:`repro.models`: ``layers``, ``blockwise``, the GQA half of
``attention`` and the dense ``transformer``), whose decode attention runs
the ``decode_attention`` kernel on the card."""
