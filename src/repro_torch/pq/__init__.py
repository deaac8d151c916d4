"""Product quantisation (port of :mod:`repro.pq`): codebooks, the
vector <-> code transforms and ADC (``adc_topk`` is the port's bulk
retrieval over the ``pq_scan`` and ``topk`` kernels)."""
from repro_torch.pq.codebook import PqCodebook, split_subspaces, train_pq  # noqa: F401
from repro_torch.pq.adc import adc_distances, adc_topk, build_lut  # noqa: F401
from repro_torch.pq.encode import pq_decode, pq_encode  # noqa: F401
