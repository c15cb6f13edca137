"""The VidTIMIT audio-video talking-heads dataset (the port's own copy of
multimodal_dmm_tpu/data/vidtimit.py).

Modalities ``audio`` (stacked STFT spectrogram slices, (10, 1281) = 5
frames x (log-magnitude + phase), 25 slices a second) and ``video``
(3x64x64 frames in [0, 1]), matched by ``{subject}_{sentence}.npy`` file
names under ``audio/`` and ``video/``. ``wav_to_spec``/``spec_to_wav``
are the invertible spectrogram transform (STFT window 2560 at 32 kHz,
5-frame channel stacking, magnitudes log-normalised to [0, 1], phase to
[0, 1]); ``gen_synthetic`` writes an offline fixture in the corpus's
layout. scipy is imported inside the functions that use it.

The corpus itself is not fetched here: its download and conversion need
the network, PIL and scikit-image. A data directory without the
fixture's or the converted corpus's ``.npy`` files raises
``FileNotFoundError``.
"""

import os

import numpy as np

from .multiseq import MultiseqDataset

fps = 25.0
audio_rate = 32000
subjects = [
    'fadg0', 'faks0', 'fcft0', 'fcmh0', 'fcmr0', 'fcrh0', 'fdac1',
    'fdms0', 'fdrd1', 'fedw0', 'felc0', 'fgjd0', 'fjas0', 'fjem0',
    'fjre0', 'fjwb0', 'fkms0', 'fpkt0', 'fram1', 'mabw0', 'mbdg0',
    'mbjk0', 'mccs0', 'mcem0', 'mdab0', 'mdbb0', 'mdld0', 'mgwt0',
    'mjar0', 'mjsw0', 'mmdb1', 'mmdm2', 'mpdf0', 'mpgl0', 'mrcz0',
    'mreb0', 'mrgg0', 'mrjo0', 'msjs1', 'mstk0', 'mtas1', 'mtmr0',
    'mwbt0'
]


class VidTIMITDataset(MultiseqDataset):
    """The VidTIMIT set in ``data_dir`` (``audio/`` and ``video/`` of
    ``.npy`` files); each sequence is truncated to its shorter
    modality."""

    def __init__(self, data_dir, base_rate=None, item_as_dict=False):
        audio_dir = os.path.join(data_dir, 'audio')
        video_dir = os.path.join(data_dir, 'video')
        for d in (audio_dir, video_dir):
            if (not os.path.isdir(d)
                    or not any(f[-3:] == 'npy' for f in os.listdir(d))):
                raise FileNotFoundError(
                    "no VidTIMIT .npy files in %r; the corpus is not "
                    "downloaded here: make an offline fixture with "
                    "multimodal_dmm_tpu_torch.data.vidtimit.gen_synthetic"
                    "(data_dir)" % d)
        super().__init__(
            modalities=['audio', 'video'], dirs=[audio_dir, video_dir],
            regex=r"(\w+)_(\w+)\.npy", preprocess=None,
            rates=fps, base_rate=base_rate, truncate=True,
            ids_as_mods=[], item_as_dict=item_as_dict)


def wav_to_spec(wav, rate):
    """Waveform -> stacked spectrogram slices (n_windows, 10, n_freqs),
    25 windows a second."""
    import scipy.signal
    win_sz = rate / fps * 2  # 2560 at 32 kHz
    f, t, spec = scipy.signal.stft(wav, rate, nperseg=win_sz,
                                   noverlap=win_sz / 2)
    spec = spec.T
    overlap = 2
    n_wins = spec.shape[0]
    spec = np.pad(spec, [(overlap, overlap), (0, 0)], mode='constant')
    spec = spec[np.arange(n_wins)[:, None]
                + np.arange(overlap * 2 + 1)]
    mag, phase = np.abs(spec), np.angle(spec)
    eps = 1e-7
    max_mag = win_sz * 2
    mag = ((np.log(mag + eps) - np.log(eps))
           / (np.log(max_mag + eps) - np.log(eps)))
    phase = (phase + np.pi) / (2 * np.pi)
    return np.concatenate([mag, phase], axis=1)


def spec_to_wav(spec, rate):
    """The inverse of ``wav_to_spec``: the central frame of each slice
    through the inverse STFT."""
    import scipy.signal
    win_sz = rate / fps * 2
    eps = 1e-7
    max_mag = win_sz * 2
    mag = spec[:, :spec.shape[1] // 2]
    mag = np.exp(mag * (np.log(max_mag + eps) - np.log(eps))
                 + np.log(eps)) + eps
    phase = spec[:, spec.shape[1] // 2:]
    phase = phase * (2 * np.pi) - np.pi
    spec = mag * np.cos(phase) + mag * np.sin(phase) * 1j
    overlap = 2
    spec = spec[:, overlap, :]
    spec = spec.T
    t, wav = scipy.signal.istft(spec, rate, nperseg=win_sz,
                                noverlap=win_sz / 2)
    return wav


def gen_synthetic(dest, n_subjects=4, n_sentences=3, t_range=(40, 80),
                  seed=1):
    """Offline fixture in the corpus's layout: ``audio/`` and ``video/``
    of ``{subject}_{sentence}.npy`` (sentences sa1, sa2, si1, ...), the
    audio a harmonic waveform per subject with noise through
    ``wav_to_spec``, the video a moving square. The same arguments give
    the same files as the JAX package's ``gen_synthetic``."""
    aud_dir = os.path.join(dest, 'audio')
    vid_dir = os.path.join(dest, 'video')
    for d in (dest, aud_dir, vid_dir):
        os.makedirs(d, exist_ok=True)
    rng = np.random.RandomState(seed)
    sentences = ['sa1', 'sa2'] + [f'si{i}' for i in
                                  range(1, n_sentences - 1)]
    for s_i in range(n_subjects):
        subj = subjects[s_i]
        for sent in sentences[:n_sentences]:
            t_len = rng.randint(*t_range)
            n_samples = int(t_len * audio_rate / fps)
            ts = np.arange(n_samples) / audio_rate
            f0 = 100 + 30 * s_i
            wav = sum(np.sin(2 * np.pi * f0 * (k + 1) * ts) / (k + 1)
                      for k in range(4))
            wav = (wav * 0.3 + rng.randn(n_samples) * 0.01)
            spec = wav_to_spec(wav.astype(np.float32), audio_rate)
            video = np.zeros((t_len, 3, 64, 64), np.float32)
            color = rng.rand(3) * 0.8 + 0.2
            for t in range(t_len):
                cy = int(26 + 10 * np.sin(0.3 * t))
                video[t, :, cy:cy + 12, 26:38] = color[:, None, None]
            video += rng.rand(*video.shape).astype(np.float32) * 0.05
            video = np.clip(video, 0, 1)
            np.save(os.path.join(aud_dir, f"{subj}_{sent}.npy"),
                    spec.astype(np.float32))
            np.save(os.path.join(vid_dir, f"{subj}_{sent}.npy"), video)


def test_dataset(data_dir='./vidTIMIT', stats=False):
    """Load the set in ``data_dir`` and print its sequence IDs, a
    collated batch's shapes and (``stats``) per-modality statistics."""
    from .multiseq import seq_collate
    print("Loading data...")
    dataset = VidTIMITDataset(data_dir)
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
        audio, video = dataset[i]
        if len(audio) != len(video):
            print("WARNING: Mismatched sequence lengths at",
                  dataset.seq_ids[i])
    if stats:
        m_mean, m_std = dataset.mean_and_std()
        m_max, m_min = dataset.max_and_min()
        for m in ['audio', 'video']:
            print("--", m, "--")
            print("Mean:", m_mean[m], "Std:", m_std[m])
            print("Max:", m_max[m], "Min:", m_min[m])


if __name__ == '__main__':
    import argparse
    parser = argparse.ArgumentParser()
    parser.add_argument('--data_dir', type=str, default='./vidTIMIT')
    parser.add_argument('--stats', action='store_true', default=False)
    parser.add_argument('--synthetic', action='store_true', default=False,
                        help='generate the offline synthetic fixture')
    args = parser.parse_args()
    if args.synthetic:
        gen_synthetic(args.data_dir)
    test_dataset(args.data_dir, args.stats)
