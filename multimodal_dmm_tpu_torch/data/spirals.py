"""Noisy 2D spirals: the corpus generator and its loader (the port's own
copy of multimodal_dmm_tpu/data/spirals.py).

``gen_dataset`` writes the corpus from ``numpy.random`` seed 1: 1,000
spirals of 100 steps, 600 in ``train/`` and 400 in ``test/``, one CSV file
each with the columns x, y, noisy_x, noisy_y, r, theta, direction, ratio,
written with the ``csv`` module as the JAX package writes them with
pandas (the shortest round-trip repr of each float), so the two packages
write the same bytes. ``SpiralsDataset`` reads a subset: modalities
``spiral-x`` and ``spiral-y`` (the noisy coordinates) and ``metadata`` (the
other six columns).
"""

import csv
import os

import numpy as np
import numpy.random as rand

from .multiseq import MultiseqDataset

COLUMNS = ["x", "y", "noisy_x", "noisy_y", "r", "theta", "direction",
           "ratio"]


class SpiralsDataset(MultiseqDataset):
    """The spirals of ``base_dir/subset`` (the corpus is generated there
    first if the subset's directory does not exist)."""

    def __init__(self, modalities, base_dir, subset, base_rate=None,
                 truncate=False, item_as_dict=False):
        subset_dir = os.path.join(base_dir, subset)
        if not os.path.exists(subset_dir):
            gen_dataset(data_dir=base_dir)
        if "metadata" not in modalities:
            modalities = list(modalities) + ["metadata"]
        preprocess = {
            "spiral-x": lambda tab: tab.select(["noisy_x"]),
            "spiral-y": lambda tab: tab.select(["noisy_y"]),
            "metadata": lambda tab: tab.drop(["noisy_x", "noisy_y"]),
        }
        rates = 1.0
        super().__init__(
            modalities, subset_dir, r"spiral_(\d+)\.csv",
            [preprocess[m] for m in modalities], rates,
            base_rate if base_rate is not None else rates, truncate, [],
            item_as_dict)


def gen_spiral(start_r, stop_r, start_theta, stop_theta, aspect_ratio=1,
               timesteps=100):
    r = np.linspace(start_r, stop_r, timesteps)
    theta = np.linspace(start_theta, stop_theta, timesteps)
    x = (aspect_ratio ** 0.5) * r * np.cos(theta)
    y = (aspect_ratio ** -0.5) * r * np.sin(theta)
    return r, theta, x, y


def gen_spirals(n_examples=1000, timesteps=100):
    """The corpus from ``numpy.random`` seed 1: (the file numbers in
    writing order, the first ``n_train`` of them the training set; the
    spirals, spiral j the (timesteps, 8) array of ``COLUMNS`` in file
    ``spiral_j.csv``)."""
    rand.seed(1)
    indices = list(range(n_examples))
    rand.shuffle(indices)
    spirals = []
    for i in range(n_examples):
        direction = 1 if (i >= n_examples / 2) else -1
        start_r = 0.25 + rand.random() * 0.5
        stop_r = 2.25 + rand.random() * 0.5
        start_theta = direction * (rand.random() * np.pi)
        stop_theta = direction * (rand.random() * np.pi + np.pi * 4)
        ratio = 2 ** (2 * rand.random() - 1)
        r, theta, x, y = gen_spiral(start_r, stop_r, start_theta,
                                    stop_theta, ratio, timesteps)
        noisy_x = x + 0.1 * rand.randn(timesteps)
        noisy_y = y + 0.1 * rand.randn(timesteps)
        spirals.append(np.stack([x, y, noisy_x, noisy_y, r, theta,
                                 [direction] * timesteps,
                                 [ratio] * timesteps], axis=1))
    return indices, spirals


def gen_dataset(n_examples=1000, n_train=600, timesteps=100,
                data_dir="./spirals"):
    """Write the corpus of ``gen_spirals`` to ``data_dir/{train,test}``:
    the first ``n_train`` in writing order to ``train``."""
    for sub in ("train", "test"):
        os.makedirs(os.path.join(data_dir, sub), exist_ok=True)
    indices, spirals = gen_spirals(n_examples, timesteps)
    for i in range(n_examples):
        subset = "train" if i < n_train else "test"
        path = os.path.join(data_dir, subset,
                            "spiral_{:03d}.csv".format(indices[i]))
        with open(path, "w", newline="") as f:
            writer = csv.writer(f, lineterminator="\n")
            writer.writerow(COLUMNS)
            writer.writerows([repr(float(v)) for v in row]
                             for row in spirals[indices[i]])


def test_dataset(data_dir="./spirals", subset="train", stats=False):
    """Load ``data_dir/subset`` and print a collated batch's shapes, its
    lengths, any sequence whose modalities differ in length and
    (``stats``) per-modality statistics, as the JAX module prints them."""
    from .multiseq import seq_collate
    print("Loading data...")
    dataset = SpiralsDataset(["spiral-x", "spiral-y"], data_dir, subset)
    print("Testing batch collation...")
    data = seq_collate([dataset[i] for i in range(min(10, len(dataset)))])
    print("Batch shapes:")
    for d in data[:-2]:
        print(d.shape)
    print("Sequence lengths: ", data[-1])
    for i in range(len(dataset)):
        x, y = dataset[i][:2]
        if len(x) != len(y):
            print("WARNING: Mismatched sequence lengths at",
                  dataset.seq_ids[i])
    if stats:
        m_mean, m_std = dataset.mean_and_std()
        m_max, m_min = dataset.max_and_min()
        for m in dataset.modalities:
            print("--", m, "--")
            print("Mean:", m_mean[m], "Std:", m_std[m])
            print("Max:", m_max[m], "Min:", m_min[m])


if __name__ == "__main__":
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument("--n_examples", type=int, default=1000)
    parser.add_argument("--n_train", type=int, default=600)
    parser.add_argument("--timesteps", type=int, default=100)
    parser.add_argument("--data_dir", type=str, default="./spirals")
    parser.add_argument("--test", action="store_true", default=False)
    parser.add_argument("--subset", type=str, default="train")
    parser.add_argument("--stats", action="store_true", default=False)
    args = parser.parse_args()
    if args.test:
        test_dataset(args.data_dir, args.subset, args.stats)
    else:
        gen_dataset(args.n_examples, args.n_train, args.timesteps,
                    args.data_dir)
