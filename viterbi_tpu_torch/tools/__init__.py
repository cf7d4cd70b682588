"""The evidence tools: the twins of the JAX package's evidence
scripts, each run as ``python -m viterbi_tpu_torch.tools.<name>`` and each
writing its record at the repository's root beside the ``_TPU.json`` it
mirrors.

* ``parity`` (``scripts/tpu_parity.py``): every rung and kernel form
  against the golden model, twelve sections -> ``PARITY_GPU.json``;
* ``latency`` (``scripts/latency_bench.py``): p50 and p99 of one call at
  small batches -> ``LATENCY_GPU.json``;
* ``ladder`` (``scripts/ladder_bench.py``): the resident rate of every DAB
  bitrate -> ``LADDER_GPU.json``;
* ``stream``, ``session``, ``ingest`` (``scripts/{stream,session,
  ingest}_bench.py``) -> ``STREAM_GPU.json``, ``SESSION_GPU.json``,
  ``INGEST_GPU.json``;
* ``overlap_sweep`` (``scripts/overlap_sweep.py``) ->
  ``OVERLAP_SWEEP_GPU.json``;
* ``make_corpus`` (``scripts/make_corpus.py``): the capture corpus again,
  into a directory given on the command line.

Every tool runs on the card unless the caller passes ``device="cpu"``
(``--device cpu``); without a card and without that it raises. A record
taken on the CPU is never written under a ``_GPU.json`` name, and any
mismatch sets ``"ok": false`` and a non-zero exit code (``_record``).
"""
