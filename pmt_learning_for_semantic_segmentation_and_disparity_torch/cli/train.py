"""CLI entry point of the port — flag-compatible with the reference
(torch_implementation.py main, README.md:25) and with the JAX package's CLI:

    python -m pmt_learning_for_semantic_segmentation_and_disparity_torch.cli.train \
        -colorL train_colorL.txt -colorR train_colorR.txt \
        -seg seg.txt -disp disp.txt -inst inst.txt \
        -net sdnet_mini_ext -backbone densenet -corrType 1dcorr \
        -crop 256 512 -b 8 -e 100 -loss cross_entropy lovasz_loss \
        -output_activation linear -datasetName roses -train 1

It runs on one card. ``main(argv, device="cpu")`` runs it on the CPU.
Data-parallel over N cards, one process each:

    torchrun --nproc_per_node N -m \
        pmt_learning_for_semantic_segmentation_and_disparity_torch.cli.train <flags>
"""
from __future__ import annotations

from ..core.config import config_from_args
from ..parallel.mesh import make_mesh, setup_distributed
from ..training.loop import Session, eval_batch_size


def main(argv=None, device=None) -> Session:
    """Train (``-train 1``: epochs, per-row eval, checkpoints, resume with
    ``-load_weights``) or evaluate (``-train 0``: per-image tables and the
    mean±std summary). Returns the session.

    In a rank of a multi-process run (torchrun's ``WORLD_SIZE`` > 1, or the
    JAX package's ``PMT_*`` variables; ``parallel.setup_distributed``: NCCL
    on the card, gloo on the CPU, or a group the caller started) the session
    runs over ``make_mesh()`` on the rank's card: ``-b`` is the global batch,
    each rank loads, trains on and evaluates its slice, and rank 0 alone
    prints and writes checkpoints. ``-gpu_n``, ``-n`` and ``-nr`` stay
    unused, as in the JAX package."""
    mesh = make_mesh(device=device) if setup_distributed(device=device) else None
    cfg = config_from_args(argv)
    say = print if mesh is None or mesh.rank == 0 else (lambda *args: None)
    say(f"model id: {cfg.model_id()}")
    session = Session(cfg, device, mesh)
    if cfg.run.train:
        history = session.fit()
        if history:
            say("final eval:", history[-1])
        return session
    from ..data.datasets import build_datasets, normalization_for
    from ..data.pipeline import DataLoader

    norm = normalization_for(cfg.model.backbone, cfg.model.net)
    _, testset = build_datasets(
        cfg.data, cfg.model.output_activation, cfg.model.max_disp, norm,
        train=False,
    )
    # tail batches are padded and the padded rows masked (Session.evaluate
    # drops them), so the metrics equal a batch-1 eval — the reference's
    # test_model runs batch 1, torch_implementation.py:450
    loader = DataLoader(
        testset, eval_batch_size(cfg.run.batch, len(testset), session.ranks), shuffle=False,
        drop_last=False, bucket_hw=cfg.data.eval_shape, pad_batch=True,
        process_index=session.rank, process_count=session.ranks,
    )
    session.init_state()
    if cfg.run.load_weights:
        session.restore(cfg.run.load_weights)
    metrics = session.evaluate(
        loader,
        show_per_step=True,
        artifacts_dir="testResults" if (cfg.run.show_results or
                                        cfg.run.save_img) else None,
    )
    say(metrics)
    return session


if __name__ == "__main__":
    main()
