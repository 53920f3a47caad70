"""The reconstruction-quality witness and the audio demo (ports of
``scripts/quality_check.py`` and ``scripts/make_demo.py``):

* ``quality_check`` — train ``tiny`` on the synthetic harmonic set,
  reconstruct held-out tones through the decode engines, report the
  band-spectral correlation, the harmonic energy ratio and the
  speaker-conditioning matrix, and hold them to the gate
  (``quality_gate``);
* ``make_demo``     — the before/after wavs, ``metrics.json`` and, where
  matplotlib imports, the spectrogram triptych.

Both run on the card (``--device cuda``, the default); ``--device cpu``
runs the kernels' plain versions.
"""
