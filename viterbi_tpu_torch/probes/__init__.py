"""Timing probes of the card's integer pipeline: the Hopper counterparts
of the TPU probe scripts ``scripts/kablate.py``, ``scripts/kdtype.py`` and
``scripts/kilp.py``. They lie on no decode path; they answer what a
redesign of the ACS kernels has to know.

* ``kablate`` (kernel E): what each part of kernel A's step costs.
* ``kdtype`` (kernels F and G): narrow integer types and byte SIMD.
* ``kilp`` (kernel H): independent streams per thread against issue rate.
* ``rsform`` (no kernel): the RS decoder's field arithmetic through the
  tables against the JAX package's bitwise form.

Each kernel's module has the kernel's wrapper (its launches counted by
the launch path, ``ops._build.Kernel``, as every kernel's), a plain
PyTorch version of the same function (taken for CPU tensors only) and a
``main()`` that prints the probe's table on the card:
``python -m viterbi_tpu_torch.probes.kablate`` and so on. The kernels
(``csrc/probes/*.cu``) are a library of their own, built at a probe's
first use.
"""
