"""Train the PyTorch PhaseNet on synthetic P/S wavelets, on the CUDA card.

The twin of examples/train_picker_synthetic.py for the port
(`seismic_bpmf_tpu_torch`): the same synthetic windows, training with
`train_phasenet` (Adam), a checkpoint round trip as `torch.save` state
dicts, and the trained picker run through the reference picker protocol
(`make_picker`) on held-out windows.

Run: python examples/train_picker_synthetic_torch.py [n_epochs] [--cpu]
"""

import os
import sys

# allow running from a repo checkout without installing the package
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tempfile

import numpy as np

from seismic_bpmf_tpu_torch.models import (
    PhaseNet,
    load_variables,
    make_picker,
    save_variables,
    train_phasenet,
)

WINDOW = 3001
SR = 100.0


def synth_window(rng, window=WINDOW, noise=0.3):
    """One 3-component window with a P wavelet on Z and an S wavelet on
    N/E at random times; returns (x (window, 3), (p_samp, s_samp))."""
    x = noise * rng.normal(size=(window, 3)).astype(np.float32)
    t = np.arange(200)
    p_pick = rng.integers(400, window // 2)
    s_pick = p_pick + rng.integers(300, 1200)
    f_p = rng.uniform(4.0, 12.0)
    f_s = rng.uniform(2.0, 8.0)
    wav_p = np.sin(2 * np.pi * f_p * t / SR) * np.hanning(len(t))
    wav_s = np.sin(2 * np.pi * f_s * t / SR) * np.hanning(len(t))
    amp = rng.uniform(1.0, 4.0)
    x[p_pick : p_pick + len(t), 2] += amp * wav_p
    for c in (0, 1):
        x[s_pick : s_pick + len(t), c] += 1.5 * amp * wav_s
    std = x.std(axis=0, keepdims=True)
    x = (x - x.mean(axis=0, keepdims=True)) / np.where(std > 0, std, 1.0)
    return x, (p_pick, s_pick)


def main(n_epochs=8, n_train=512, device=None):
    rng = np.random.default_rng(0)
    xs, picks = [], []
    for _ in range(n_train):
        x, (p, s) = synth_window(rng)
        xs.append(x.T)  # torch's layout: (3, window)
        picks.append([p, s])
    x = np.stack(xs)
    picks = np.asarray(picks, np.float32)

    model, _, losses = train_phasenet(
        x, picks, n_epochs=n_epochs, batch_size=32, learning_rate=1e-3,
        sigma=20.0, verbose=True, device=device,
    )
    assert losses[-1] < losses[0], "loss did not decrease"

    # checkpoint round trip into a fresh model on the same device
    ckpt_dir = tempfile.mkdtemp(prefix="phasenet_ckpt_")
    save_variables(ckpt_dir, model)
    model = PhaseNet().to(next(model.parameters()).device)
    load_variables(ckpt_dir, target=model)
    print(f"checkpoint -> {ckpt_dir}")

    # evaluate through the reference picker protocol on held-out windows
    picker = make_picker(model, norm_window=WINDOW - 1)
    hits, errs = 0, []
    n_eval = 32
    for _ in range(n_eval):
        xw, (p, s) = synth_window(rng)
        probas = picker(xw.T[None, :, :])  # (1, 2, window)
        p_hat = int(np.argmax(probas[0, 0]))
        s_hat = int(np.argmax(probas[0, 1]))
        if abs(p_hat - p) < 50 and abs(s_hat - s) < 50:
            hits += 1
        errs.append((abs(p_hat - p), abs(s_hat - s)))
    errs = np.asarray(errs)
    print(f"eval: {hits}/{n_eval} windows with both picks within 0.5 s; "
          f"median |P err| {np.median(errs[:, 0]):.0f} samp, "
          f"|S err| {np.median(errs[:, 1]):.0f} samp")
    return hits / n_eval


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    n_epochs = int(args[0]) if args else 8
    acc = main(n_epochs=n_epochs,
               device="cpu" if "--cpu" in sys.argv[1:] else None)
    print("OK" if acc >= 0.5 else "WARN: low pick accuracy")
