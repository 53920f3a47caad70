"""One rank of a gloo world for the port's parallel tests
(``tests/_torch_world.py``): ``torchrun --nproc-per-node N
_torch_mesh_worker.py JOB OUT`` joins the world torchrun describes,
runs ``job_JOB`` and writes its result to ``OUT/rank<r>.pt``.  Inputs that the JAX package
computed come in ``OUT/inputs.npz``."""

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)

from vqvae_tpu_torch.audio.framing import frame_batch  # noqa: E402
from vqvae_tpu_torch.configs import get_config  # noqa: E402
from vqvae_tpu_torch.models import forward, init_model  # noqa: E402
from vqvae_tpu_torch.parallel import collectives as col  # noqa: E402
from vqvae_tpu_torch.parallel.distributed import (  # noqa: E402
    initialize_from_env,
    put_global_batch,
    warmup_collectives,
)
from vqvae_tpu_torch.parallel.mesh import (  # noqa: E402
    batch_sharding,
    groups,
    make_mesh,
    mesh_shape,
    param_shardings,
)

# meshes over a world of 4 (make_mesh's keyword arguments)
MESHES = [{}, {"model": 2}, {"data": 2, "model": 2}, {"data": 1, "model": 4},
          {"seq": 2}, {"data": 2, "seq": 2}, {"data": 1, "seq": 2, "model": 2},
          {"slices": 2}, {"slices": 2, "data": 2},
          {"slices": 2, "data": 1, "model": 2}]


def mesh_key(kw):
    return ",".join(f"{k}={v}" for k, v in sorted(kw.items())) or "default"


def job_mesh(out):
    res = {"meshes": {}}
    for kw in MESHES:
        m = make_mesh(device_type="cpu", **kw)
        bs = batch_sharding(m)
        g = groups(m)
        res["meshes"][mesh_key(kw)] = {
            "shape": mesh_shape(m), "axes": bs.axes, "rows": bs.rows(8),
            "sizes": {k: col.size(getattr(g, k)) for k in g._fields}}
    cfg = get_config("tiny")
    params = init_model(cfg.model, torch.Generator().manual_seed(0))
    m = make_mesh(model=2, device_type="cpu")
    res["shards"] = {k: s.shard_shape(p.shape) for (k, s), p in zip(
        param_shardings(m, params).items(), params.state_dict().values())}
    from vqvae_tpu_torch.models import init_vq_state
    vq = init_vq_state(params)
    res["vq_shards"] = {k: s.shard_shape(getattr(vq, k).shape)
                        for k, s in param_shardings(m, vq).items()}
    # the collectives, on the world and on the mesh's groups
    warmup_collectives(m)
    r = dist.get_rank()
    t = torch.full((3,), float(r))
    col.all_reduce_(t, dist.group.WORLD, mean=True)
    res["mean"] = t.tolist()
    res["gather"] = col.all_gather(torch.tensor([r, 10 * r]),
                                   groups(m).model).tolist()
    wav = np.arange(8 * 5, dtype=np.float32).reshape(8, 5)
    sl = batch_sharding(m).rows(8)
    res["put"] = put_global_batch(m, wav[sl]).numpy()
    res["put_rows"] = sl
    return res


def _batches(cfg, n, seed=0):
    rng = np.random.default_rng(seed)
    B, L = cfg.train.batch_size, cfg.data.length + 1
    t = np.arange(L) / cfg.data.sr
    out = []
    for _ in range(n):
        f = rng.uniform(100, 800, (B, 1))
        wav = (0.5 * np.sin(2 * np.pi * f * t)
               + 0.05 * rng.standard_normal((B, L))).astype(np.float32)
        out.append((wav, rng.integers(0, cfg.data.n_speakers, B)))
    return out


def _train(cfg, mesh, batches):
    """(last metrics, full params, full VQ state) after the batches."""
    from vqvae_tpu_torch.train.state import create_train_state
    from vqvae_tpu_torch.train.step import train_step
    st = create_train_state(cfg, "cpu", mesh=mesh)
    rows = batch_sharding(mesh).rows(cfg.train.batch_size)
    for wav, spk in batches:
        m = train_step(st, *put_global_batch(mesh, wav[rows], spk[rows]),
                       cfg)
    vq = st.vq_state if st.par is None else st.par.full_vq(st.vq_state)
    return ({k: float(v) for k, v in m.items()},
            {k: v.detach().clone() for k, v in st.params.state_dict().items()},
            {"count": vq.count.clone(), "sum": vq.sum.clone()})


def _grads(cfg, mesh, wav, spk):
    """Every parameter's gradient as the mesh's optimizer sees it after
    the reduction, gathered whole."""
    from vqvae_tpu_torch.train.state import create_train_state
    st = create_train_state(cfg, "cpu", mesh=mesh)
    rows = batch_sharding(mesh).rows(cfg.train.batch_size)
    w, s = put_global_batch(mesh, wav[rows], spk[rows])
    b = frame_batch(w, s, cfg.model.mu, cfg.model.mulaw_mode)
    loss, _ = forward(st.params, cfg.model, b, "lax", mesh)
    loss.backward()
    if st.par is None:
        return {n.replace(".", "/"): p.grad.clone()
                for n, p in st.params.named_parameters()
                if p.grad is not None}
    st.par.reduce_grads()
    return st.par.full_grads()


def _cfg(batch=8, **model):
    cfg = get_config("tiny")
    return cfg.replace(
        train=dataclasses.replace(cfg.train, batch_size=batch),
        model=dataclasses.replace(cfg.model, **model))


DP_CASES = [(False, 0.0, 1.0), (True, 0.0, 1.0), (True, 1e-3, 1.0),
            (False, 1e-3, 1.0), (False, 1e-3, 20.0)]
KERNELS = {"decoder_kernel": "pallas_sg", "head_kernel": "pallas",
           "embed_in_kernel": True}


def job_train(out):
    """Rank 0 also runs every case on one device ("one")."""
    lead = dist.get_rank() == 0
    res = {}

    def run(name, cfg, batches, **mesh_kw):
        mesh = make_mesh(device_type="cpu", **mesh_kw)
        res[name] = _train(cfg, mesh, batches)
        if lead and name.endswith("/dp"):
            res[name.replace("/dp", "/one")] = _train(cfg, None, batches)

    for ema, thr, mult in DP_CASES:
        cfg = _cfg(ema=ema, code_restart_threshold=thr)
        cfg = cfg.replace(train=dataclasses.replace(
            cfg.train, codebook_lr_mult=mult))
        run(f"ema={ema},restart={thr},mult={mult}/dp", cfg, _batches(cfg, 3))
    cfg = _cfg(ema=True, code_restart_threshold=1e-3)
    run("ema_tp/dp", cfg, _batches(cfg, 1))
    run("ema_tp/dp_tp", cfg, _batches(cfg, 1), data=2, model=2)
    cfg = _cfg(**KERNELS)
    run("kernels/dp", cfg, _batches(cfg, 1))
    run("kernels/dp_tp", cfg, _batches(cfg, 1), data=2, model=2)
    cfg = _cfg()
    run("slices/dp", cfg, _batches(cfg, 1))
    run("slices/slices", cfg, _batches(cfg, 1), slices=2, data=2)
    for n in (1, 2):
        run(f"sp{n}/dp", cfg, _batches(cfg, 2, seed=1)[:n])
        run(f"sp{n}/dp_sp", cfg, _batches(cfg, 2, seed=1)[:n], data=2,
            seq=2)
    wav, spk = _batches(cfg, 1, seed=2)[0]
    kcfg = _cfg(**KERNELS)
    for name, c, kw in (("dp", cfg, {}),
                        ("dp_tp", cfg, {"data": 2, "model": 2}),
                        ("dp_sp", cfg, {"data": 2, "seq": 2}),
                        ("slices", cfg, {"slices": 2, "data": 2}),
                        ("kernels_dp", kcfg, {}),
                        ("kernels_dp_tp", kcfg, {"data": 2, "model": 2})):
        res[f"grads/{name}"] = _grads(c, make_mesh(device_type="cpu", **kw),
                                      wav, spk)
    if lead:
        res["grads/one"] = _grads(cfg, None, wav, spk)
        res["grads/kernels_one"] = _grads(kcfg, None, wav, spk)
    return res


def job_sp(out):
    from vqvae_tpu_torch.convert import from_numpy_tree
    from vqvae_tpu_torch.models.wavenet import apply_decoder
    from vqvae_tpu_torch.ops.conv import causal_conv_apply
    from vqvae_tpu_torch.parallel.sharded_conv import sharded_causal_conv
    from vqvae_tpu_torch.parallel.sp_decoder import apply_decoder_sp, \
        time_slice
    lead = dist.get_rank() == 0
    with np.load(os.path.join(out, "inputs.npz")) as z:
        inp = {k: z[k] for k in z.files}
    res = {}
    # the causal conv over the 'data' axis of make_mesh() (4 slices)
    mesh = make_mesh(device_type="cpu")
    x = torch.from_numpy(inp["conv_x"])
    T = x.shape[1]
    sl = time_slice(mesh, T, "data")
    for dil in inp["conv_dils"].tolist():
        w = torch.from_numpy(inp["conv_w"]).requires_grad_(True)
        b = torch.from_numpy(inp["conv_b"]).requires_grad_(True)
        xl = x[:, sl].clone().requires_grad_(True)
        y = sharded_causal_conv({"w": w, "b": b}, xl, dil, mesh)
        (y * torch.from_numpy(inp["conv_cot"])[:, sl]).sum().backward()
        gw, gb = w.grad.clone(), b.grad.clone()
        col.all_reduce_(gw, dist.group.WORLD)
        col.all_reduce_(gb, dist.group.WORLD)
        res[f"conv/{dil}"] = {"y": y.detach(), "dx": xl.grad, "dw": gw,
                              "db": gb, "rows": sl}
        if lead:
            w0 = torch.from_numpy(inp["conv_w"]).requires_grad_(True)
            b0 = torch.from_numpy(inp["conv_b"]).requires_grad_(True)
            x0 = x.clone().requires_grad_(True)
            y0 = causal_conv_apply({"w": w0, "b": b0}, x0, dil)
            (y0 * torch.from_numpy(inp["conv_cot"])).sum().backward()
            res[f"conv/{dil}/one"] = {"y": y0.detach(), "dx": x0.grad,
                                      "dw": w0.grad, "db": b0.grad}
    # the decoder stack over 'seq', 2 and 4 slices
    cfg = get_config("tiny").model
    flat = {k[len("p/"):]: v for k, v in inp.items() if k.startswith("p/")}
    ids = torch.from_numpy(inp["ids"]).long()
    cond = torch.from_numpy(inp["cond"])
    spk = torch.from_numpy(inp["spk"]).long()
    cot = torch.from_numpy(inp["dec_cot"])
    for n in (2, 4):
        mesh = make_mesh(data=4 // n, seq=n, device_type="cpu")
        params = from_numpy_tree(flat, trainable=True)
        sl = time_slice(mesh, ids.shape[1], "seq")
        logits = apply_decoder_sp(params, cfg, ids, cond, spk, mesh,
                                  axis="seq")
        (logits * cot[:, sl]).sum().backward()
        grads = {}
        for k, p in params.named_parameters():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            grads[k] = col.all_reduce_(g.clone(), groups(mesh).seq)
        res[f"dec/{n}"] = {"logits": logits.detach(), "rows": sl,
                           "grads": grads}
    if lead:
        params = from_numpy_tree(flat, trainable=True)
        logits = apply_decoder(params["decoder"], cfg, ids, cond, spk)
        (logits * cot).sum().backward()
        res["dec/one"] = {"logits": logits.detach(), "grads": {
            k: (p.grad if p.grad is not None else torch.zeros_like(p))
            for k, p in params.named_parameters()}}
    # a dilation larger than a slice is refused, on every rank
    mesh = make_mesh(data=1, seq=4, device_type="cpu")
    params = from_numpy_tree(flat)
    try:
        apply_decoder_sp(params, cfg, ids[:1, :1024], cond[:1, :1024],
                         spk[:1], mesh, axis="seq")
        res["refused"] = None
    except AssertionError as exc:
        res["refused"] = str(exc)
    return res


def main():
    job, out = sys.argv[1], sys.argv[2]
    assert initialize_from_env(device="cpu")
    res = globals()[f"job_{job}"](out)
    dist.barrier()
    torch.save(res, os.path.join(out, f"rank{dist.get_rank()}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
