"""One rank of a multi-process run of the PyTorch port, for the two-rank
tests (tests/test_torch_parallel.py) and chip_smoke.py's phase 16:

    python tests/torch_dp_worker.py PAYLOAD RANK WORLD PORT OUT [BACKEND]

joins the process group at ``localhost:PORT`` (gloo unless BACKEND says
otherwise), runs the task that the ``torch.save``'d PAYLOAD names and
``torch.save``s its result to OUT. Imports torch and the port only.

Tasks (``payload["task"]``):
  * ``helpers``: the parallel helpers on rank-dependent inputs;
  * ``step``: one ``make_train_step`` step of the detector that
    ``payload["model"]`` describes (``build_model``) on this rank's slice
    of the global batch, the sampling noise replayed from
    ``payload["draws"]`` (the global batch's, by stream);
  * ``ll4al``: one LL4AL joint step, likewise;
  * ``vaal``: one VAAL VAE + discriminator step, the reparameterisation
    normals replayed;
  * ``al_loop``: ``cli.driver.al_loop`` of ``ALConfig(**payload["cfg"])``
    (on ``payload["datasets"]``, VOC (root, split) pairs, where given),
    with the training steps, the agreed step counts, the detects, the
    checkpoint writes and (``payload["count_kernels"]``) the RoIAlign
    kernels' launches of this rank;
  * ``train``: ``cli.train.train`` of ``ALConfig(**payload["cfg"])``.
"""

from __future__ import annotations

import functools
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cald_tpu_torch import parallel  # noqa: E402


def replay(draws: dict):
    """A draw that returns the recorded global arrays, by stream."""
    def draw(stream, shape, **_):
        out = torch.from_numpy(np.asarray(draws[stream]))
        assert tuple(out.shape) == tuple(shape), (stream, out.shape, shape)
        return out
    return draw


def local_rows(arrays, rank: int, world: int):
    """This rank's rows of global (N * B, ...) arrays, as tensors."""
    out = []
    for a in arrays:
        b = len(a) // world
        out.append(torch.from_numpy(np.ascontiguousarray(a[rank * b:(rank + 1) * b])))
    return out


def task_helpers(payload, rank, world):
    from cald_tpu_torch.cli.driver import _Lockstep, _sync_len

    n = payload["n"]
    return {"shard": parallel.process_shard(range(n)),
            "shard_nopad": parallel.process_shard(range(n), pad=False),
            "objects": parallel.all_gather_objects({"rank": rank, "items": list(range(rank + 1))}),
            "merge": parallel.process_merge_sum(np.arange(6, dtype=np.float64) * (rank + 1)),
            "sync_len": _sync_len(rank + 3),
            "lockstep": len(list(_Lockstep(list(range(rank + 3))))),
            "gather": parallel.gather_cat(torch.full((2,), float(rank))).tolist()}


def _params(*modules):
    return [{n: p.detach().cpu().clone() for n, p in m.named_parameters()} for m in modules]


def build_model(spec: dict):
    """A detector from ``{"kind": "faster" | "retina", "cfg": its config,
    "state_dict": ...}`` on ``spec["device"]`` (the CPU unless given), in
    training mode."""
    from cald_tpu_torch.models.faster_rcnn import FasterRCNN
    from cald_tpu_torch.models.retinanet import RetinaNet

    model = {"faster": FasterRCNN, "retina": RetinaNet}[spec["kind"]](spec["cfg"])
    model.load_state_dict(spec["state_dict"], strict=True)
    return model.to(spec.get("device", "cpu")).train()


def _device_rows(payload, rank, world):
    dev = payload["model"].get("device", "cpu")
    return [t.to(dev) for t in local_rows(payload["batch"], rank, world)]


def _replayed(payload):
    dev = payload["model"].get("device", "cpu")
    draw = replay(payload["draws"])
    return parallel.process_draw(lambda i, shape, **kw: draw(i, shape, **kw).to(dev))


def task_step(payload, rank, world):
    from cald_tpu_torch.engine.optim import make_sgd
    from cald_tpu_torch.engine.train import make_train_step

    model = build_model(payload["model"])
    opt = make_sgd(model, payload["lr"], frozen_prefixes=payload["frozen"])
    step = make_train_step(model, opt)
    metrics = step(*_device_rows(payload, rank, world), _replayed(payload))
    return {"metrics": {k: float(v) for k, v in metrics.items()}, "params": _params(model)[0]}


def task_ll4al(payload, rank, world):
    from cald_tpu_torch.engine.optim import make_sgd
    from cald_tpu_torch.strategies.ll4al import make_ll_train_step

    model, lossnet = build_model(payload["model"]), payload["lossnet"]
    opt = make_sgd(model, payload["lr"], frozen_prefixes=payload["frozen"])
    ll_opt = make_sgd(lossnet, payload["lr"])
    step = make_ll_train_step(model, lossnet, opt, ll_opt, ll_weight=payload["ll_weight"])
    metrics = step(*_device_rows(payload, rank, world), _replayed(payload),
                   detach_features=payload["detach"])
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": _params(model)[0], "ll_params": _params(lossnet)[0]}


def task_vaal(payload, rank, world):
    from cald_tpu_torch.engine.optim import make_sgd
    from cald_tpu_torch.strategies.vaal import VAALTrainer

    vae_lr, d_lr = payload["lrs"]

    def optimizers(vae, disc):
        return make_sgd(vae, vae_lr), None, make_sgd(disc, d_lr), None

    trainer = VAALTrainer(optimizers, **payload["sizes"])
    trainer.vae.load_state_dict(payload["vae"])
    trainer.disc.load_state_dict(payload["disc"])
    lab, unlab = local_rows(payload["images"], rank, world)
    vloss, dloss = trainer.train_step(lab, unlab, parallel.process_draw(replay(payload["draws"])))
    vae, disc = _params(trainer.vae, trainer.disc)
    return {"losses": (float(vloss), float(dloss)), "vae": vae, "disc": disc}


def count_saves(module) -> list:
    """Patch ``module.save_checkpoint`` to count its calls; returns the
    list that grows by one per call."""
    saves, save = [], module.save_checkpoint

    def counting(*a, **k):
        saves.append(1)
        return save(*a, **k)

    module.save_checkpoint = counting
    return saves


def task_al_loop(payload, rank, world):
    from cald_tpu_torch.cli import driver
    from cald_tpu_torch.cli.config import ALConfig
    from cald_tpu_torch.data.voc import get_voc2007
    from cald_tpu_torch.strategies.vaal import VAALTrainer

    saves = count_saves(driver)
    if payload.get("vaal_sizes"):
        driver.VAALTrainer = functools.partial(VAALTrainer, **payload["vaal_sizes"])
    steps, steps_run, detects = [], [], []
    epoch, detect = driver.train_one_epoch, driver.FasterRCNN.detect

    def counting(step_fn, loader, *a, **k):
        steps.append(len(loader))
        steps_run.append(0)

        def step(*sa):
            steps_run[-1] += 1
            return step_fn(*sa)
        return epoch(step, loader, *a, **k)

    def detect_counting(model, images, valid_hw):
        detects.append(images.shape[0])
        return detect(model, images, valid_hw)

    driver.train_one_epoch = counting
    driver.FasterRCNN.detect = detect_counting
    kernels = {}
    if payload.get("count_kernels"):
        from cald_tpu_torch.ops import roi_align_cuda as rac

        kernels = {"roi_align": rac.roi_align_kernel,
                   "roi_align_train_fwd": rac.roi_align_train_fwd_kernel,
                   "roi_align_bwd": rac.roi_align_bwd_kernel,
                   "roi_align_group_fwd": rac.roi_align_group_fwd_kernel}
        for k in kernels.values():
            k.launches = 0
    datasets = None
    if payload.get("datasets"):
        datasets = tuple(get_voc2007(*payload["datasets"][k]) for k in ("train", "test"))
    history = driver.al_loop(ALConfig(**payload["cfg"]), datasets=datasets)
    return {"history": history, "steps": steps, "steps_run": steps_run, "detects": detects,
            "saves": len(saves), "launches": {n: k.launches for n, k in kernels.items()}}


def task_train(payload, rank, world):
    from cald_tpu_torch.cli import train
    from cald_tpu_torch.cli.config import ALConfig

    saves = count_saves(train)
    out = train.train(ALConfig(**payload["cfg"]))
    return {"losses": out["losses"], "eval": out["eval"], "start_epoch": out["start_epoch"],
            "params": _params(out["model"])[0], "saves": len(saves)}


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(payload: dict, workdir: str, *, world: int = 2, backend: str = "gloo",
           timeout: float = 600) -> list:
    """Run ``payload`` on ``world`` ranks, each a subprocess of this script;
    returns their results in rank order. Raises with the ranks' output when
    one fails; kills every rank on the way out."""
    import subprocess

    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "payload.pt")
    torch.save(payload, path)
    port = free_port()
    outs = [os.path.join(workdir, f"rank{r}.pt") for r in range(world)]
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), path, str(r),
                               str(world), str(port), outs[r], backend],
                              stdout=logs[r], stderr=subprocess.STDOUT)
             for r in range(world)]
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r} ---\n{f.read()}")
        f.close()
    if any(rcs):
        raise RuntimeError(f"ranks exited {rcs}:\n" + "\n".join(t[-6000:] for t in text))
    return [torch.load(o, weights_only=False) for o in outs]


TASKS = {"helpers": task_helpers, "step": task_step, "ll4al": task_ll4al, "vaal": task_vaal,
         "al_loop": task_al_loop, "train": task_train}


def main(argv) -> int:
    path, rank, world, port, out = argv[:5]
    backend = argv[5] if len(argv) > 5 else "gloo"
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    # float32 convolutions and products in full float32 on the card, as the
    # tests and chip_smoke.py run them (cuDNN's default is TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    payload = torch.load(path, weights_only=False)
    parallel.initialize_distributed(coordinator=f"localhost:{port}", num_processes=world,
                                    process_id=rank, backend=backend)
    result = TASKS[payload["task"]](payload, rank, world)
    torch.save(result, out)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
