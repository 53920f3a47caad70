"""Card-side mirrors of the JAX package's four probe scripts, each
runnable as ``python -m vqvae_tpu_torch.probes.<name>``:

* ``cond_inkernel``    — ``scripts/cond_inkernel_probe.py``: the upsampler
  built from latent frames in a kernel, forward and backward, against
  reading a materialised ``[B, T, d]`` condition;
* ``dot``              — ``scripts/mosaic_dot_probe.py``: the upsampler's
  three contractions, the leading-dim split and the time-axis
  overlap-add;
* ``reshape``          — ``scripts/mosaic_reshape_probe.py``: five in-kernel
  layouts and the matmul -> untile -> matmul composition;
* ``decode_int8_micro`` — ``scripts/decode_int8_micro.py``: a chain of
  dependent products at the decode kernel's widths, bf16 against int8.

Each checks its kernels against their plain versions, times them with
CUDA events, prints what the JAX script prints and, last, one JSON line
(``{"probe": ...}``) with the errors, times, shapes and launch counts.
They run on the card (``--device cuda``, the default); ``--device cpu``
runs the checks on the plain versions and measures no time.
"""
