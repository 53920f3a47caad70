"""The port never imports JAX: the machine with the card has none."""

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_imports_without_jax():
    code = (
        "import sys\n"
        "import vqvae_tpu_torch.cli.serve, vqvae_tpu_torch.convert\n"
        "import vqvae_tpu_torch.infer.fastgen, vqvae_tpu_torch.kernels.build\n"
        "import vqvae_tpu_torch.cli.train, vqvae_tpu_torch.train.step\n"
        "import vqvae_tpu_torch.train.loop, vqvae_tpu_torch.audio.loader\n"
        "import vqvae_tpu_torch.kernels.wavenet_train_cuda\n"
        "import vqvae_tpu_torch.kernels.head_ce_cuda\n"
        "import vqvae_tpu_torch.kernels.vq_cuda\n"
        "import vqvae_tpu_torch.audio.wav_io, vqvae_tpu_torch.audio.datasets\n"
        "import vqvae_tpu_torch.train.evaluator\n"
        "import vqvae_tpu_torch.train.checkpoint\n"
        "import vqvae_tpu_torch.kernels.encoder_cuda\n"
        "import vqvae_tpu_torch.infer, vqvae_tpu_torch.infer.lowmem\n"
        "import vqvae_tpu_torch.infer.streaming\n"
        "import vqvae_tpu_torch.cli.encode, vqvae_tpu_torch.cli.decode\n"
        "import vqvae_tpu_torch.cli.generate, vqvae_tpu_torch.cli.stream\n"
        "import vqvae_tpu_torch.cli.score, vqvae_tpu_torch.cli.export\n"
        "import vqvae_tpu_torch.client\n"
        "import vqvae_tpu_torch.utils.flops, vqvae_tpu_torch.utils.profiling\n"
        "import vqvae_tpu_torch.kernels.upsample_cuda\n"
        "import vqvae_tpu_torch.kernels.decode_chain_cuda\n"
        "import vqvae_tpu_torch.probes.cond_inkernel\n"
        "import vqvae_tpu_torch.probes.dot, vqvae_tpu_torch.probes.reshape\n"
        "import vqvae_tpu_torch.probes.decode_int8_micro\n"
        "import vqvae_tpu_torch.ops.embed, vqvae_tpu_torch.kernels.embed_cuda\n"
        "import vqvae_tpu_torch.native.bindings\n"
        "import vqvae_tpu_torch.audio.grain_loader\n"
        "import vqvae_tpu_torch.train.metrics\n"
        "import vqvae_tpu_torch.parallel, vqvae_tpu_torch.parallel.mesh\n"
        "import vqvae_tpu_torch.parallel.distributed\n"
        "import vqvae_tpu_torch.parallel.collectives\n"
        "import vqvae_tpu_torch.parallel.step\n"
        "import vqvae_tpu_torch.parallel.sharded_conv\n"
        "import vqvae_tpu_torch.parallel.sp_decoder\n"
        "import vqvae_tpu_torch.infer.parallel\n"
        "import vqvae_tpu_torch.quality.quality_check\n"
        "import vqvae_tpu_torch.quality.make_demo\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'vqvae_tpu'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
