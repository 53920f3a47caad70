"""Measurement tools of the port: one module per measurement script of
``scripts/``, each run as ``python -m vqvae_tpu_torch.measure.<name>``
on the card (``--device cpu`` runs the same code on the CPU, for its
checks; a CPU time is never a card number).

* ``step_bench``          the ``stretch`` step at B=64, best of reps
* ``embed_kernel_bench``  ``embed_in_kernel`` on against off: parity, times
* ``encoder_share``       the encoder's forward+backward against the step
* ``train_roofline``      a batch sweep: step time, share of peak, memory
* ``train_step_profile``  the step's device time by phase, and the idle
                          gaps by what the host was doing
* ``serve_bench``         request latency through the daemon's socket
* ``session_sweep``       sustained session pushes against push width
* ``decode_int8_bigbatch`` bf16 against int8 chains of products, B=2048

Each prints one JSON line (last, or before its tables) that carries the
card's name and power limit.  Nothing here is imported by the program.
"""
