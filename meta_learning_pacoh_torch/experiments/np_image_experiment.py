"""JSON-config image Neural-Process experiment driver (counterpart of
experiments/np_image_experiment.py).

    python -m meta_learning_pacoh_torch.experiments.np_image_experiment <path_to_config.json>

Reads a JSON config, builds the image NP and its epoch trainer, trains, and
after every epoch writes losses.json and model.pkl into the results
directory (config.json once, at the start).

Config keys (the original's): dataset ("mnist" | "celeba"), img_size [C, H,
W], batch_size, r_dim, h_dim, z_dim, num_context_range,
num_extra_target_range, epochs, lr; optional: path_to_data, limit (cap the
image count), results_dir (default: results_<timestamp>), seed.

model.pkl holds {"params": {name: numpy array}, "config": config}: the
model's parameters under the JAX model's names, which
``NeuralProcessImg.load_params`` takes back into a fresh model.
"""

import json
import os
import pickle
import sys
from time import strftime

import numpy as np


def model_arrays(np_img):
    """{name: numpy array} of an image NP's parameters."""
    from meta_learning_pacoh_torch.models.random_gp import unravel_flat

    return {k: v.detach().cpu().numpy().copy()
            for k, v in unravel_flat(np_img.layout, np_img.params).items()}


def run_experiment(config, results_dir=None, verbose=True, device=None):
    """Train as ``config`` says on ``device`` (None: the card); returns the
    epoch losses and the results directory."""
    from meta_learning_pacoh_torch.datasets.np_image_data import (
        celeba_image_batches,
        mnist_image_batches,
    )
    from meta_learning_pacoh_torch.models.neural_process_img import (
        NeuralProcessImg,
        NeuralProcessImgTrainer,
    )

    results_dir = results_dir or config.get(
        "results_dir", "results_{}".format(strftime("%Y-%m-%d_%H-%M")))
    os.makedirs(results_dir, exist_ok=True)
    with open(os.path.join(results_dir, "config.json"), "w") as f:
        json.dump(config, f)

    img_size = tuple(config["img_size"])
    rs = np.random.RandomState(config.get("seed", 0))
    common = dict(batch_size=config["batch_size"], size=img_size[1],
                  random_state=rs, limit=config.get("limit"))
    if config["dataset"] == "mnist":
        kwargs = dict(common)
        if config.get("path_to_data"):
            kwargs["path_to_data"] = config["path_to_data"]
        batches = mnist_image_batches(**kwargs)
    elif config["dataset"] == "celeba":
        batches = celeba_image_batches(config["path_to_data"], **common)
    else:
        raise ValueError(f"unknown dataset {config['dataset']!r}")

    np_img = NeuralProcessImg(
        img_size, r_dim=config["r_dim"], z_dim=config["z_dim"],
        h_dim=config["h_dim"], random_seed=config.get("seed", 0), device=device)
    trainer = NeuralProcessImgTrainer(
        np_img, lr=config["lr"],
        num_context_range=tuple(config["num_context_range"]),
        num_extra_target_range=tuple(config["num_extra_target_range"]))

    for epoch in range(config["epochs"]):
        if verbose:
            print("Epoch {}".format(epoch + 1), flush=True)
        trainer.train(batches, 1, verbose=verbose)
        with open(os.path.join(results_dir, "losses.json"), "w") as f:
            json.dump([float(x) for x in trainer.epoch_loss_history], f)
        with open(os.path.join(results_dir, "model.pkl"), "wb") as f:
            pickle.dump({"params": model_arrays(np_img), "config": config}, f)
    return trainer.epoch_loss_history, results_dir


def main(argv=None, device=None):
    """Run the config named by ``argv`` (the arguments after the program's
    name; None: ``sys.argv[1:]``) on ``device`` (None: the card)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    if len(argv) != 1:
        raise RuntimeError(
            "Wrong arguments, use python -m meta_learning_pacoh_torch.experiments."
            "np_image_experiment <path_to_config>")
    with open(argv[0]) as f:
        config = json.load(f)
    losses, results_dir = run_experiment(config, device=device)
    print(f"done: {len(losses)} epoch losses in {results_dir}/losses.json")
    return losses, results_dir


if __name__ == "__main__":
    main()
