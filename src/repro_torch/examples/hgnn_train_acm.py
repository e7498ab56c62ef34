"""End-to-end example: train an HGNN on synthetic ACM through the
``repro_torch.api`` surface.  One ``ExecutorSpec`` picks the NA executor
(the banded one runs kernels K1 and K2 forward and their transposes
backward over one cached packing); ``Session.compile`` binds model and
batches; ``CompiledHGNN.fit`` trains with no backend arguments.

  python -m repro_torch.examples.hgnn_train_acm [--steps 100]
      [--model rgat] [--na-executor jnp|banded] [--scale 1.0] [--device cpu]

On the CPU the banded executor runs the kernels' plain versions: keep
--scale <= 0.25 with it there.
"""
import argparse
import time

from repro_torch.api import ExecutorSpec, Session, device_features
from repro_torch.core.hgnn import HGNNConfig
from repro_torch.hetero import make_dataset
from repro_torch.train import propagated_feature_labels, semi_supervised_masks

TARGETS = ["APA", "PAP", "PSP", "PTP"]


def main(argv=None) -> dict:
    """Run the flow; returns its products (the compiled model, labels,
    masks and ``fit``'s result)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--model", default="rgat", choices=["rgcn", "rgat", "shgn"])
    ap.add_argument("--na-executor", "--na-backend", dest="na_executor",
                    default="jnp", choices=["jnp", "banded"])
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    g = make_dataset("ACM", scale=args.scale)
    sess = Session(ExecutorSpec(na_executor=args.na_executor, device=args.device))
    compiled = sess.compile(g, TARGETS, HGNNConfig(
        model=args.model, hidden=64, num_layers=3, num_classes=3,
        target_type="P"))
    feats = device_features(g, args.device)

    n = compiled.num_target
    labels = propagated_feature_labels(compiled.semantic, TARGETS, g.features, n,
                                       device=args.device)
    masks = semi_supervised_masks(n, seed=0, device=args.device)

    t0 = time.time()

    def progress(step, loss):
        if step % 25 == 0 or step == args.steps - 1:
            print(f"step {step:4d}  loss {loss:.4f}  "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step)")

    out = compiled.fit(feats, labels, masks, epochs=args.steps,
                       epoch_callback=progress)
    print(f"done [{args.na_executor}]: train_acc {out['train_acc']:.3f}  "
          f"val_acc {out['val_acc']:.3f}  test_acc {out['test_acc']:.3f}")
    return {"graph": g, "compiled": compiled, "features": feats, "labels": labels,
            "masks": masks, "fit": out}


if __name__ == "__main__":
    main()
