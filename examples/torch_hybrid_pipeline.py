"""The paper's motivating application as a Session stage DAG, on the port.

The PyTorch counterpart of ``examples/hybrid_pipeline.py``: the
'simulate, cluster trajectories, refine' loop realized as 'train,
cluster activations, adapt', placed by the Session across an HPC-runtime
pilot and an analytics-runtime pilot:

    simulate (hpc)  --traj-->  analyze (analytics)  --centroids-->  train (hpc)

``simulate`` trains with the port's Trainer (K3 and its backward in every
Mamba layer), ``analyze`` runs K-Means with the k-means kernel (K1).
On the card by default:

    PYTHONPATH=src python examples/torch_hybrid_pipeline.py [--dcn-cost 1.0]

``--device cpu`` runs it on the CPU (the kernels' plain versions).
:func:`make_round` and :func:`run_pipeline` take the config and the
sizes, so other programs run the same DAG at other widths.
"""
import argparse
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch.analytics import kmeans as km
from repro_torch.core import (PilotDescription, ResourceManager, Session,
                              TransferCostModel, analytics_stage, hpc_stage)
from repro_torch.core.dataplane import Link
from repro_torch.data.batches import make_batch
from repro_torch.models import transformer
from repro_torch.optim import adamw
from repro_torch.train.trainer import Trainer

ROUNDS = 3
STEPS_PER_ROUND = 10
K = 4


def make_round(cfg, rnd: int, box: Dict, *, batch: int = 4, seq: int = 32,
               steps_per_round: int = STEPS_PER_ROUND, lr: float = 3e-3,
               on_analyze: Optional[Callable] = None) -> List:
    """One round of the DAG: simulate -> analyze -> train(steered).  `box`
    carries the trainer and the last loss from round to round;
    `on_analyze(engine)` runs around each analyze (e.g. to count K1)."""

    def simulate(mesh=None, results=None):
        seed = results.get(f"train-{rnd - 1}", 0) if results else 0
        tr = box.get("tr")
        if tr is None:
            tr = Trainer(cfg, mesh, global_batch=batch, seq=seq,
                         hyper=adamw.Hyper(lr=lr), seed=seed)
            box["tr"] = tr
        tr.pipeline.seed = seed
        hist = tr.run((rnd + 1) * steps_per_round, log_every=0)
        box["loss"] = hist[-1]["loss"]
        # 'trajectory' data: output logits of a probe batch, 3 features
        rng = np.random.default_rng(seed)
        probe = make_batch(cfg, "train", batch, seq, rng, device=tr.device)
        with torch.no_grad():
            logits, _ = transformer.forward(cfg, tr.state["params"], probe,
                                            remat=False)
        return {"traj": logits.reshape(-1, logits.shape[-1])[:, :3]
                .float().contiguous()}

    def analyze(engine=None, traj=None):
        run = (lambda: km.kmeans_fit(engine, "traj", K, iters=3,
                                     use_kernel=True))
        centroids, cost = on_analyze(run) if on_analyze else run()
        return {"centroids": centroids, "cost": cost}

    def train(centroids=None, results=None, mesh=None):
        # steer: next round's data seed chosen from the cluster cost
        return int(results[f"analyze-{rnd}"]["cost"]) % 997

    return [
        hpc_stage(f"simulate-{rnd}", simulate, outputs=("traj",)),
        analytics_stage(f"analyze-{rnd}", analyze, inputs=("traj",),
                        outputs=("centroids",)),
        hpc_stage(f"train-{rnd}", train, inputs=("centroids",),
                  after=(f"analyze-{rnd}",)),
    ]


def run_pipeline(session: Session, cfg, *, rounds: int = ROUNDS,
                 **round_kw) -> List[Dict]:
    """Run `rounds` rounds on a Session with pilots ``hpc`` and ``ana``;
    prints and returns each round's loss, cost and placement."""
    box: Dict = {}
    out = []
    for rnd in range(rounds):
        session.run(make_round(cfg, rnd, box, **round_kw))
        place = session.placements[f"analyze-{rnd}"]
        rec = {"round": rnd, "loss": box["loss"],
               "cost": session.results[f"analyze-{rnd}"]["cost"],
               "pilot": place["pilot"], "mode": place["mode"],
               "dcn_bytes_moved": place["dcn_bytes_moved"],
               "next_seed": session.results[f"train-{rnd}"]}
        out.append(rec)
        print(f"round {rnd}: train loss {rec['loss']:.3f} | "
              f"kmeans cost {rec['cost']:.1f} | "
              f"analytics placed on '{rec['pilot']}' ({rec['mode']}) | "
              f"dcn moved {rec['dcn_bytes_moved']} B | "
              f"next seed {rec['next_seed']}")
    ledger = session.dataplane.ledger()
    print(f"data-plane ledger: total {ledger['total']} B moved, "
          f"dcn {ledger['by_link'][Link.DCN]} B, "
          f"ici {ledger['by_link'][Link.ICI]} B")
    return out


def make_session(device: torch.device,
                 dcn_cost: Optional[float] = None) -> Session:
    """Two pilots over one device pool (logical slots alias the device)."""
    cost_model = TransferCostModel()
    if dcn_cost is not None:
        cost_model.dcn_cost_per_byte = dcn_cost
    session = Session(ResourceManager(devices=[device] * 2),
                      cost_model=cost_model)
    session.add_pilot(PilotDescription(n_chips=1, name="hpc", runtime="hpc"))
    session.add_pilot(PilotDescription(n_chips=1, name="ana",
                                       runtime="analytics"))
    return session


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--dcn-cost", type=float, default=None,
                        help="inter-pilot cost per byte (default: model "
                             "default)")
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    parser.add_argument("--rounds", type=int, default=ROUNDS)
    parser.add_argument("--steps-per-round", type=int,
                        default=STEPS_PER_ROUND)
    args = parser.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    session = make_session(torch.device(args.device), args.dcn_cost)
    try:
        run_pipeline(session, configs.get_smoke("hymba-1.5b"),
                     rounds=args.rounds,
                     steps_per_round=args.steps_per_round)
    finally:
        session.shutdown()
    print("pipeline complete.")


if __name__ == "__main__":
    main()
