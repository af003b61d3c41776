"""Stage-1 CLI of the port (counterpart of
holoscene_tpu/training/exp_runner.py).

    python -m holoscene_tpu_torch.training.exp_runner --conf confs/x.conf \
        [--exps_folder exps] [--is_continue] [--timestamp latest] \
        [--checkpoint latest] [--max_niters N] [--data_root DIR] [--quiet] \
        [--device cuda]

--device defaults to cuda (the hand-written kernels; it fails without a
card); --device cpu runs the kernels' plain versions. --is_continue
resumes from the run's latest checkpoint, the port's .pth or the JAX
package's .msgpack.

Several ranks: launch under torchrun and name the backend,

    torchrun --nproc_per_node N -m holoscene_tpu_torch.training.exp_runner \
        --conf confs/x.conf --dist_backend nccl [--n_model M]

(one card a rank; --dist_backend gloo runs two ranks on one card, which
NCCL refuses). The process group is read from torchrun's environment
(MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE); rank r uses card
LOCAL_RANK mod the card count. A failed initialisation fails the run.
"""

from __future__ import annotations

import argparse
import os

import torch
import torch.distributed as dist

from holoscene_tpu_torch.config import ConfigFactory
from holoscene_tpu_torch.training.stage1 import Stage1Runner


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf", type=str, required=True)
    parser.add_argument("--expname", type=str, default="",
                        help="suffix appended to train.expname")
    parser.add_argument("--exps_folder", type=str, default="exps")
    parser.add_argument("--ft_folder", type=str, default=None,
                        help="finetune: load checkpoints from this run dir")
    parser.add_argument("--is_continue", action="store_true")
    parser.add_argument("--timestamp", type=str, default="latest")
    parser.add_argument("--checkpoint", type=str, default="latest")
    parser.add_argument("--max_niters", type=int, default=None,
                        help="override train.max_total_iters")
    parser.add_argument("--data_root", type=str, default=None,
                        help="override dataset.data_root_dir")
    parser.add_argument("--log_every", type=int, default=20,
                        help="record (and print) the metrics every N steps")
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument(
        "--device", type=str, default="cuda",
        help="torch device; 'cuda' launches the hand-written kernels and "
             "fails without a card, 'cpu' runs their plain versions")
    parser.add_argument(
        "--dist_backend", choices=("nccl", "gloo"), default=None,
        help="train over the ranks torchrun started, with this "
             "torch.distributed backend")
    parser.add_argument("--n_model", type=int, default=1,
                        help="ranks a hash table's rows are sharded over")
    args = parser.parse_args(argv)

    device = args.device
    if args.dist_backend is not None:
        dist.init_process_group(args.dist_backend, init_method="env://")
        if device == "cuda":
            local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
            device = f"cuda:{local % torch.cuda.device_count()}"
            torch.cuda.set_device(device)
    conf = ConfigFactory.parse_file(args.conf)
    runner = Stage1Runner(
        conf, exps_folder=args.exps_folder, data_root_override=args.data_root,
        is_continue=args.is_continue, timestamp=args.timestamp,
        checkpoint=args.checkpoint, max_total_iters=args.max_niters,
        quiet=args.quiet, expname_suffix=args.expname,
        ft_folder=args.ft_folder, device=device, n_model=args.n_model)
    runner.run(log_every=args.log_every)
    if args.dist_backend is not None:
        dist.destroy_process_group()
    return runner


if __name__ == "__main__":
    main()
