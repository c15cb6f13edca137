"""The Weizmann human-action video dataset (the port's own copy of
multimodal_dmm_tpu/data/weizmann.py).

Modalities ``video`` (3x64x64 frames in [0, 1]) and ``mask`` (1x64x64
silhouettes) from ``{person}_{action}.npy`` and
``{person}_{action}_mask.npy``, with ``person`` and ``action`` label
modalities taken from the file names. ``gen_synthetic`` writes an offline
fixture in the same layout; ``download_weizmann`` fetches and converts the
real corpus (network, scipy, scikit-video and scikit-image, each imported
only there) and is not reached when the data directory holds ``.npy``
files.
"""

import os

import numpy as np

from .multiseq import MultiseqDataset

fps = 25.0
persons = ['daria', 'denis', 'eli', 'ido', 'ira',
           'lena', 'lyova', 'moshe', 'shahar']
actions = ['bend', 'jack', 'jump', 'pjump', 'run',
           'side', 'skip', 'walk', 'wave1', 'wave2']
descriptions = ['Bend', 'Jumping jack', 'Jump',
                'Jump in place', 'Run', 'Gallop sideways',
                'Skip', 'Walk', 'One-hand wave', 'Two-hand wave']

duplicates = ['lena_walk', 'lena_run', 'lena_skip']


class WeizmannDataset(MultiseqDataset):
    """The Weizmann set in ``data_dir`` (downloaded there if it holds no
    ``.npy`` file)."""

    def __init__(self, data_dir, base_rate=None, item_as_dict=False):
        if (not os.path.exists(data_dir) or
                not any(f[-3:] == 'npy' for f in os.listdir(data_dir))):
            download_weizmann(dest=data_dir)
        super().__init__(
            modalities=['video', 'mask'], dirs=data_dir,
            regex=[r"([^_\W]+)_([^_\W]+)\.npy",
                   r"([^_\W]+)_([^_\W]+)_mask\.npy"],
            preprocess=None, rates=25, base_rate=base_rate,
            truncate=False, ids_as_mods=['person', 'action'],
            item_as_dict=item_as_dict)


def _download(fname, source, dest):
    """Fetch ``source + fname`` into ``dest`` unless it is there."""
    import urllib.request
    path = os.path.join(dest, fname)
    if not os.path.exists(path):
        print("Downloading {}...".format(fname))
        urllib.request.urlretrieve(source + fname, path)
    return path


def download_weizmann(dest='./weizmann'):
    """Download the corpus and convert it to ``.npy`` (needs network
    access, scipy, scikit-video with ffmpeg, and scikit-image)."""
    src_url = ('http://www.wisdom.weizmann.ac.il/~vision/'
               'VideoAnalysis/Demos/SpaceTimeActions/DB/')
    import zipfile
    try:
        import scipy.io
        import skvideo.io
    except ImportError as e:
        raise RuntimeError(
            "Weizmann download needs scipy + scikit-video; in offline "
            "environments use weizmann.gen_synthetic(dest) instead.") \
            from e

    ffmpeg_params = {'-s': '64x64', '-vf': 'crop=128:128:26:8'}
    os.makedirs(dest, exist_ok=True)
    masks = scipy.io.loadmat(_download('classification_masks.mat', src_url,
                                       dest))
    masks = masks['original_masks'][0, 0]
    for act in actions:
        zip_path = _download(act + '.zip', src_url, dest)
        with zipfile.ZipFile(zip_path, "r") as f:
            vid_names = [vn for vn in f.namelist() if vn[-3:] == 'avi']
            print("Extracting '{}' videos... ({} files)".format(
                act, len(vid_names)))
            f.extractall(dest, members=vid_names)
        for vn in vid_names:
            vn_no_ext = vn[:-4]
            if vn_no_ext[:-1] in duplicates and vn_no_ext[-1] == '2':
                continue
            print("Converting {} to NPY...".format(vn))
            vid_data = preprocess_video(skvideo.io.vread(
                os.path.join(dest, vn), outputdict=ffmpeg_params))
            mask_data = preprocess_mask(masks[vn_no_ext])
            if vn_no_ext[:-1] in duplicates:
                vn_no_ext = vn_no_ext[:-1]
            np.save(os.path.join(dest, vn_no_ext + '.npy'), vid_data)
            np.save(os.path.join(dest, vn_no_ext + '_mask.npy'), mask_data)


def preprocess_video(video):
    """(T, H, W, C) uint8 frames -> the central square, in [0, 1], as
    (T, C, H, W)."""
    height, width = video.shape[1:3]
    side = min(height, width)
    x0 = (width - side) // 2
    y0 = (height - side) // 2
    video = np.array(video[:, y0:y0 + side, x0:x0 + side])
    return np.transpose(video, (0, 3, 1, 2)) / 255.0


def preprocess_mask(mask):
    """(H, W, T) silhouettes -> the central square resized to 64x64, as
    (T, 1, 64, 64)."""
    import skimage.transform
    height, width = mask.shape[0:2]
    side = min(height, width)
    x0 = (width - side) // 2
    y0 = (height - side) // 2
    mask = np.array(mask[y0:y0 + side, x0:x0 + side, :]).astype(np.float64)
    mask = np.transpose(mask, (2, 0, 1))
    mask = np.stack([skimage.transform.resize(mask[t], (64, 64))
                     for t in range(mask.shape[0])], axis=0)
    return mask[:, np.newaxis, :, :]


def gen_synthetic(dest, persons_subset=None, actions_subset=None,
                  t_range=(30, 60), img_size=64, seed=1):
    """Offline fixture in the corpus's file layout: per (person, action) a
    video of a moving square (path from the action, colour from the
    person, uniform noise) and its silhouette. The same arguments give the
    same files."""
    if persons_subset is None:
        persons_subset = persons
    if actions_subset is None:
        actions_subset = actions
    os.makedirs(dest, exist_ok=True)
    rng = np.random.RandomState(seed)
    for p_i, person in enumerate(persons_subset):
        for a_i, action in enumerate(actions_subset):
            t_len = rng.randint(*t_range)
            video = np.zeros((t_len, 3, img_size, img_size), np.float32)
            mask = np.zeros((t_len, 1, img_size, img_size), np.float32)
            color = rng.rand(3) * 0.8 + 0.2
            for t in range(t_len):
                cx = int((img_size - 12) *
                         (0.5 + 0.4 * np.sin(0.2 * t + a_i)))
                cy = int((img_size - 12) *
                         (0.5 + 0.4 * np.cos(0.15 * t + p_i)))
                video[t, :, cy:cy + 12, cx:cx + 12] = color[:, None, None]
                mask[t, 0, cy:cy + 12, cx:cx + 12] = 1.0
            video += rng.rand(*video.shape).astype(np.float32) * 0.05
            video = np.clip(video, 0.0, 1.0)
            np.save(os.path.join(dest, f"{person}_{action}.npy"), video)
            np.save(os.path.join(dest, f"{person}_{action}_mask.npy"),
                    mask)


def test_dataset(data_dir='./weizmann', stats=False):
    """Load the set in ``data_dir`` and print its sequence IDs, a
    collated batch's shapes, any sequence whose modalities differ in
    length and (``stats``) per-modality statistics, as the JAX module
    prints them."""
    from .multiseq import seq_collate
    print("Loading data...")
    dataset = WeizmannDataset(data_dir)
    print("Number of sequences:", len(dataset))
    print("Sequence ID values:")
    for s in dataset.seq_id_sets:
        print(s)
    print("Testing batch collation...")
    data = seq_collate([dataset[i]
                        for i in range(min(10, len(dataset)))])
    print("Batch shapes:")
    for d in data[:-2]:
        print(d.shape)
    print("Sequence lengths: ", data[-1])
    for i in range(len(dataset)):
        video, mask, person, action = dataset[i]
        if (len(video) != len(person) or len(video) != len(action)
                or len(video) != len(mask)):
            print("WARNING: Mismatched sequence lengths at",
                  dataset.seq_ids[i])
    if stats:
        m_mean, m_std = dataset.mean_and_std()
        m_max, m_min = dataset.max_and_min()
        for m in ['video', 'person', 'action']:
            print("--", m, "--")
            print("Mean:", m_mean[m], "Std:", m_std[m])
            print("Max:", m_max[m], "Min:", m_min[m])


if __name__ == '__main__':
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument('--data_dir', type=str, default='./weizmann')
    parser.add_argument('--stats', action='store_true', default=False)
    parser.add_argument('--synthetic', action='store_true', default=False,
                        help='generate the offline synthetic fixture')
    args = parser.parse_args()
    if args.synthetic:
        gen_synthetic(args.data_dir)
    test_dataset(args.data_dir, args.stats)
