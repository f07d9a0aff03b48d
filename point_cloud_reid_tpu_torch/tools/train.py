"""Training CLI of the port (the JAX package's tools/train.py).

    python -m point_cloud_reid_tpu_torch.tools.train \
        pts_point-transformer_point-cat_nus_det_4x256_500e \
        --root /data/nuscenes-reid --epochs 1 --work-dir runs/exp1 \
        --set model.knn_method=pallas \
        --set model.cross_stage1.attention=linear-pallas \
        --set model.cross_stage2.attention=linear-pallas

--root opens a crop store (objects.pkl beside the {obj}/{frame}/pts_xyz.bin
tree, as tools/make_synthetic_data.py, tools/import_reference_store.py or
the JAX package write it) and its CompleteStore; without it a
SyntheticStore of --synthetic-objects objects stands in. Either goes
through the samplers of the experiment's train and val specs
(data/samplers.py) and two BatchLoaders: train shuffled per epoch, val in
order with drop_last, as in the JAX CLI, since the metric depends on which
pairs are kept. An on-disk store reads each batch through the native
loader (native/). Trains on the CUDA device, each batch pinned in the
loader's threads; without a card it exits, unless --device cpu asks for
the CPU (every kernel's plain version; the tests). TF32 off. Checkpoints
are the port's ckpt_{tag}.pt (Trainer.save_checkpoint), which
--checkpoint, --resume and tools/test.py read; not orbax directories.

Trains and evaluates the point leaves and the image (rgb_*) leaves, as the
JAX CLI does: an image leaf reads 224 x 224 crops from an image store
(tools/make_synthetic_data.py --images) or a SyntheticStore with images;
its ViT starts from the seeded init, as the JAX model's does (--checkpoint
loads other weights). The JAX CLI's flags:
  --bf16     bf16 compute, float32 parameters and optimizer state (the
             closing eval of a point leaf runs the bf16 SA kernel);
             tools/test.py --bf16 evaluates at bf16;
  --remat    the backward recomputes each stage's forward (SA, FP and
             cross stages, heads, ViT blocks; torch.utils.checkpoint):
             one stage's activations live at a time, for a second forward;
  --profile DIR  a torch.profiler trace of Trainer.fit, DIR/trace.json.

On N cards, data parallel, as the JAX CLI under JAX_* (one step over the
global batch; train/loop.py):

    torchrun --standalone --nproc_per_node N -m \
        point_cloud_reid_tpu_torch.tools.train EXPERIMENT ...

Each process joins the group from torchrun's environment
(parallel.init_distributed: NCCL on cards, gloo with --device cpu), trains
on cuda:LOCAL_RANK and loads its shard of every global batch; the global
batch is samples_per_device x N (--batch-size sets it, rounded down to a
multiple of N). Rank 0 writes the checkpoints, the logs and the printed
metrics. tools/test.py and tools/parity_eval.py evaluate the same way.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("experiment", help="experiment name (configs.EXPERIMENTS)")
    p.add_argument("--root", default=None,
                   help="crop-store root; synthetic data when omitted")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="port checkpoint (ckpt_{tag}.pt or a model "
                        "state_dict) to load weights from; optimizer and "
                        "step start fresh")
    p.add_argument("--resume", default=None,
                   help="checkpoint to resume the full training state from "
                        "(weights + optimizer + step)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the training run "
                        "to DIR/trace.json (chrome://tracing, Perfetto)")
    p.add_argument("--seed", type=int, default=66)       # reference default
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="pairs per step; default samples_per_device")
    p.add_argument("--eval-only", action="store_true")
    p.add_argument("--synthetic-objects", type=int, default=60)
    p.add_argument("--loader-threads", type=int, default=2,
                   help="BatchLoader worker threads; each batch's crop reads "
                        "run in the native loader's own pool")
    p.add_argument("--remat", action="store_true",
                   help="recompute each stage's forward in the backward "
                        "(torch.utils.checkpoint): less activation memory")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 compute; parameters and optimizer state "
                        "stay float32")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="cpu runs every kernel's plain version (tests)")
    p.add_argument("--set", dest="set_options", action="append", default=[],
                   metavar="KEY.PATH=VALUE",
                   help="dotted-path config override (repeatable), e.g. "
                        "--set losses_to_use.match=false --set schedule.lr=1e-4 "
                        "--set model.knn_method=pallas")
    return p.parse_args(argv)


def select_device(name: str, tool: str) -> torch.device:
    """The run's device, with TF32 off: under torchrun the card of
    LOCAL_RANK; without a card, a run that did not ask for the CPU
    exits."""
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit(f"{tool} needs a CUDA device (--device cpu "
                             "runs the plain versions on the CPU)")
        from point_cloud_reid_tpu_torch.parallel.distributed import local_rank
        device = torch.device("cuda", local_rank())
        print(f"device: {torch.cuda.get_device_name(device)}",
              file=sys.stderr)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def is_image(cfg) -> bool:
    return cfg["dataset"]["train"]["mode"] == "image"


def build_all(cfg, args, device):
    """(trainer, state) of an experiment dict on `device`: the JAX CLI's
    build_all (stores, samplers, loaders, model, trainer). Under torchrun
    it joins the process group first (parallel.init_distributed), sizes
    the global batch by the world size and shards the loaders by rank."""
    from point_cloud_reid_tpu_torch.data import (BatchLoader, CompleteStore,
                                                 CropStore, SyntheticStore,
                                                 build_pair_dataset)
    from point_cloud_reid_tpu_torch.models import build_model
    from point_cloud_reid_tpu_torch.parallel import init_distributed
    from point_cloud_reid_tpu_torch.train import Trainer, TrainState, pin_batch

    dist_info = init_distributed(device=device.type)
    world = dist_info["process_count"]

    dcfg = cfg["dataset"]
    losses = cfg.get("losses_to_use", {})
    with_dense = bool(losses.get("shape") or losses.get("dense"))
    dcfg = dict(dcfg,
                train=dict(dcfg["train"], with_dense=with_dense),
                val=dict(dcfg["val"], with_dense=with_dense))
    if args.root:
        store = CropStore(args.root)
        complete_store = CompleteStore(
            args.root, subsample_num=dcfg.get("subsample_dense", 2048))
    else:
        image = is_image(cfg)
        store = SyntheticStore(
            num_objects=args.synthetic_objects,
            class_names=list(dcfg["train"]["classes"]), with_images=image,
            crop_size=(224, 224) if image else (32, 32))
        complete_store = store              # synthetic store carries shapes
    train_ds = build_pair_dataset(dcfg["train"], store, complete_store)
    val_ds = build_pair_dataset(dcfg["val"], store, complete_store)

    # the global batch: samples_per_device a process, a multiple of the
    # world size (the JAX CLI's sizing by device count)
    batch = args.batch_size or dcfg["samples_per_device"] * world
    batch = max(world, min(batch, max(len(train_ds) // 2, world)))
    batch -= batch % world
    loader = dict(batch_size=batch, num_threads=max(1, args.loader_threads),
                  transform=pin_batch if device.type == "cuda" else None,
                  shard_id=dist_info["process_index"], num_shards=world)
    train_loader = BatchLoader(train_ds, shuffle=True, seed=args.seed,
                               **loader)
    val_loader = BatchLoader(val_ds, shuffle=False, drop_last=True, **loader)

    model = build_model(cfg["model"], device=device,
                        generator=torch.Generator().manual_seed(args.seed),
                        dtype=torch.bfloat16 if args.bf16 else torch.float32)
    sched = cfg["schedule"]
    if args.epochs:
        sched.max_epochs = args.epochs
    runtime = dict(cfg["runtime"])
    runtime.update(
        work_dir=args.work_dir, seed=args.seed, max_epochs=sched.max_epochs,
        losses_to_use=cfg["losses_to_use"], alpha=cfg["alpha"],
        cls_to_idx=dcfg["cls_to_idx"], num_classes=dcfg["num_classes"],
        fp_label_threshold=dcfg["fp_label_threshold"],
        triplet_margin=cfg.get("triplet_margin", 0.2),
        triplet_sample_num=cfg.get("triplet_sample_num", 5),
        remat=args.remat)
    trainer = Trainer(model, train_loader, val_loader, runtime)
    state = TrainState.create(model, sched,
                              steps_per_epoch=max(len(train_loader), 1))
    if args.resume:
        state = trainer.load_checkpoint(state, args.resume)
    elif args.checkpoint:
        state = trainer.load_weights(state, args.checkpoint)
    return trainer, state


def scalars(metrics) -> str:
    return json.dumps({k: v for k, v in metrics.items()
                       if not isinstance(v, dict)}, indent=1)


def process_group() -> dict:
    """The run's process group as the logs record it (backend None and
    world 1 without one)."""
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()):
        return dict(backend=None, world=1, rank=0)
    return dict(backend=dist.get_backend(), world=dist.get_world_size(),
                rank=dist.get_rank())


def finish() -> None:
    """Leave the process group, if the run joined one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def main(argv=None):
    args = parse_args(argv)
    from point_cloud_reid_tpu_torch.configs import get_experiment
    cfg = get_experiment(args.experiment, set_options=args.set_options)
    train = not (args.eval_only or cfg["runtime"].get("eval_only"))
    device = select_device(args.device, "tools.train")
    trainer, state = build_all(cfg, args, device)
    group = process_group()
    print(f"process group: {json.dumps(group)}", file=sys.stderr)
    trainer.logger.log_config(dict(experiment=args.experiment, seed=args.seed,
                                   schedule=str(cfg["schedule"]),
                                   model=cfg["model"], process_group=group))
    if train:
        from point_cloud_reid_tpu_torch.utils.profiling import trace_context
        with trace_context(args.profile):
            state = trainer.fit(state)
    metrics = trainer.evaluate(state)
    if trainer.writer:
        print(scalars(metrics))
    finish()
    return metrics


if __name__ == "__main__":
    main()
