"""Epoch-scale twin parity of the PyTorch/CUDA port (the counterpart of
tools/twin_epochs.py, whose "ours" is the JAX package).

    python tools/twin_epochs_torch.py [--device cuda] [--epochs 4] [--subpart 120] [--init_checkpoint CKPT] [--out FILE]

Both twins train the flagship model on the same synthetic-audio clip
stream, each through its own featurization:

  ours: int16 audio → K1 (ops/fused_mel.py) → device-fitted scaler → the
        port's Mean-Teacher step (train/steps.py), through `Experiment`
  twin: the same int16 audio → torch.stft configured like the reference's
        librosa call (hamming, center, reflect) → Slaney mel →
        amplitude_to_db → its own scaler fit → the reference loop body
        (main.py:52-165) on a model built from torch.nn primitives
        (`TorchCRNN`, a copy of the twin of tests/test_crnn_parity.py:23-95)

Shared by construction: initial weights (the twin's are copied from the
port's student and teacher), batch order and stream composition, loss
masks, ramp-up, Adam and EMA hyperparameters, decode and SED scoring.
Independent by design: featurization numerics and the teacher noise (the
twin draws its own |N(0, 0.25)| from numpy). Dropout is 0 in both.

Two modes: fresh (the default), E epochs from the port's initial state,
per-epoch mean losses compared and the decoded metrics at the end; and
--init_checkpoint CKPT, a trained port checkpoint imported into both, the
decoded event / weak F1 compared, then E more epochs. On a card both twins
run on the card. Writes --out; exits 1 if the twins diverge beyond
--loss_tol / --f1_tol, 2 without a card (unless --device cpu).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch
import torch.nn as nn

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


# ------------------------------------------------- the twin model (a copy)


class TorchGLU(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.linear = nn.Linear(ch, ch)

    def forward(self, x):  # x NCHW
        lin = self.linear(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        return lin * torch.sigmoid(x)


class TorchCRNN(nn.Module):
    """The CRNN assembled from torch.nn primitives (3×[conv3×3 → BN → GLU →
    avgpool] → BiGRU → strong head and the attention-pooled weak head), as
    tests/test_crnn_parity.py:23-61 builds it."""

    def __init__(self, cfg):
        super().__init__()
        blocks = []
        in_ch = cfg.n_in_channel
        for i, out in enumerate(cfg.nb_filters):
            blocks += [
                nn.Conv2d(in_ch, out, cfg.kernel_size[i], cfg.stride[i], cfg.padding[i]),
                nn.BatchNorm2d(out, eps=cfg.bn_eps, momentum=cfg.bn_momentum),
                TorchGLU(out),
                nn.AvgPool2d(tuple(cfg.pooling[i])),
            ]
            in_ch = out
        self.cnn = nn.Sequential(*blocks)
        self.rnn = nn.GRU(cfg.nb_filters[-1], cfg.n_rnn_cell, num_layers=cfg.n_layers_rnn,
                          bidirectional=True, batch_first=True)
        self.dense = nn.Linear(cfg.n_rnn_cell * 2, cfg.nclass)
        self.dense_softmax = nn.Linear(cfg.n_rnn_cell * 2, cfg.nclass)

    def forward(self, x):  # x [B, 1, T, F]
        x = self.cnn(x)
        x = x.squeeze(-1).permute(0, 2, 1)  # [B, T', C]
        x, _ = self.rnn(x)
        strong = torch.sigmoid(self.dense(x))
        sof = torch.softmax(self.dense_softmax(x), dim=-1).clamp(1e-7, 1.0)
        weak = (strong * sof).sum(1) / sof.sum(1)
        return strong, weak


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


def copy_params_to_torch(params, state, model, cfg):
    """The JAX-layout pytrees (params, bn_state) into a TorchCRNN
    (tests/test_crnn_parity.py:64-95)."""
    sd = {}
    for i in range(len(cfg.nb_filters)):
        base = f"cnn.{4*i}"
        sd[f"{base}.weight"] = _t(params["cnn"][i]["conv"]["w"]).permute(3, 2, 0, 1)
        sd[f"{base}.bias"] = _t(params["cnn"][i]["conv"]["b"])
        bn = f"cnn.{4*i+1}"
        sd[f"{bn}.weight"] = _t(params["cnn"][i]["bn"]["scale"])
        sd[f"{bn}.bias"] = _t(params["cnn"][i]["bn"]["bias"])
        sd[f"{bn}.running_mean"] = _t(state["cnn"][i]["mean"])
        sd[f"{bn}.running_var"] = _t(state["cnn"][i]["var"])
        sd[f"{bn}.num_batches_tracked"] = torch.tensor(0)
        glu = f"cnn.{4*i+2}.linear"
        sd[f"{glu}.weight"] = _t(params["cnn"][i]["act"]["w"]).T
        sd[f"{glu}.bias"] = _t(params["cnn"][i]["act"]["b"])
    for l, layer in enumerate(params["rnn"]):
        for d, suf in [("fwd", ""), ("bwd", "_reverse")]:
            p = layer[d]
            sd[f"rnn.weight_ih_l{l}{suf}"] = _t(p["w_ih"])
            sd[f"rnn.weight_hh_l{l}{suf}"] = _t(p["w_hh"])
            sd[f"rnn.bias_ih_l{l}{suf}"] = _t(p["b_ih"])
            sd[f"rnn.bias_hh_l{l}{suf}"] = _t(p["b_hh"])
    sd["dense.weight"] = _t(params["dense"]["w"]).T
    sd["dense.bias"] = _t(params["dense"]["b"])
    sd["dense_softmax.weight"] = _t(params["dense_softmax"]["w"]).T
    sd["dense_softmax.bias"] = _t(params["dense_softmax"]["b"])
    model.load_state_dict(sd)
    return model


# --------------------------------------------------------------- twin DSP


class TorchFrontend:
    """The reference's featurization in torch: librosa-style STFT (hamming,
    center=True, reflect) → Slaney mel (htk=False, norm=None) → per-clip
    amplitude_to_db (amin, top_db) → zeroed padding frames, on `device`.
    Reads the pipeline's packed int16 audio (reflect-padded for K1): the
    padding is stripped and torch.stft centres the clip itself."""

    def __init__(self, dsp, device):
        from dcase2019_task4_tpu_torch.ops.mel import mel_filterbank

        self.dsp, self.device = dsp, device
        fb = mel_filterbank(dsp.sample_rate, dsp.n_window, dsp.n_mels, dsp.f_min, dsp.f_max).astype(np.float32)
        self.fb = torch.from_numpy(fb).to(device)
        self.win = torch.from_numpy(np.hamming(dsp.n_window).astype(np.float32)).to(device)

    def linear_mel(self, audio_i16: np.ndarray):
        d = self.dsp
        p = d.n_window // 2
        x = torch.as_tensor(np.asarray(audio_i16), device=self.device).to(torch.float32) / 32768.0
        x = x[:, p:p + d.max_samples]
        s = torch.stft(x, n_fft=d.n_window, hop_length=d.hop_length, window=self.win, center=True,
                       pad_mode="reflect", return_complex=True)
        mag = s.abs().transpose(1, 2)[:, :d.max_frames]
        return mag @ self.fb  # [B, T, M]

    def db(self, mel, frames: np.ndarray):
        d = self.dsp
        out = torch.zeros_like(mel)
        for i in range(mel.shape[0]):
            nv = int(frames[i])
            dbi = 20.0 * torch.log10(torch.clamp(mel[i, :nv], min=d.amin))
            out[i, :nv] = torch.maximum(dbi, dbi.max() - d.top_db)
        return out

    def features(self, batch, noise_std: float = 0.0, rng=None):
        """(student, teacher): the teacher adds |N(0, std)| on the linear mel
        (reference DataLoad.py:283-287)."""
        mel = self.linear_mel(batch["audio"])
        student = self.db(mel, batch["frames"])
        if not noise_std:
            return student, student
        noise = np.abs(rng.normal(0, noise_std, tuple(mel.shape))).astype(np.float32)
        return student, self.db(mel + _t(noise).to(mel.device), batch["frames"])


def fit_torch_scaler(exp, fe: TorchFrontend):
    """The reference Scaler fit (equal weight per clip, clean features)
    through the twin featurization over all training streams, summed in
    float64 on the host."""
    from dcase2019_task4_tpu_torch.data.pipeline import iter_eval_batches

    d = exp.cfg.dsp
    total, total_sq, count = None, None, 0
    for stream in exp.pipeline.streams:
        for batch in iter_eval_batches(stream, exp.pipeline.batch_size, d.max_samples, d.n_window, d.hop_length,
                                       d.max_frames):
            nv = batch["n_valid"]
            x = fe.db(fe.linear_mel(batch["audio"]), batch["frames"])[:nv].cpu().numpy().astype(np.float64)
            m = x.mean(axis=1).sum(axis=0)
            msq = (x ** 2).mean(axis=1).sum(axis=0)
            total = m if total is None else total + m
            total_sq = msq if total_sq is None else total_sq + msq
            count += nv
    mean = total / count
    std = np.sqrt(np.maximum(total_sq / count - mean ** 2, 0.0))
    return mean.astype(np.float32), std.astype(np.float32)


# ------------------------------------------------------------- the loop


class TorchTwin:
    """The reference Mean-Teacher loop (main.py:52-165) fed by the same
    pipeline batches as the port's Experiment, through its own
    featurization and scaler, on the Experiment's device."""

    def __init__(self, exp, noise_seed: int = 1234):
        from dcase2019_task4_tpu_torch.train.checkpoints import params_to_jax

        mcfg = exp.cfg.model
        self.exp, self.device = exp, exp.device
        self.fe = TorchFrontend(exp.cfg.dsp, exp.device)
        t0 = time.time()
        self.scaler_mean, self.scaler_std = fit_torch_scaler(exp, self.fe)
        print(f"[twin] torch scaler fit in {time.time() - t0:.1f}s")
        self._mean = torch.from_numpy(self.scaler_mean).to(self.device)
        self._std = torch.from_numpy(self.scaler_std).to(self.device)
        self.model = copy_params_to_torch(*params_to_jax(exp.state.student), TorchCRNN(mcfg), mcfg).to(self.device)
        self.ema = copy_params_to_torch(*params_to_jax(exp.state.teacher), TorchCRNN(mcfg), mcfg).to(self.device)
        for p in self.ema.parameters():
            p.detach_()  # main.py:286-287
        t = exp.cfg.train
        self.opt = torch.optim.Adam(self.model.parameters(), lr=t.lr, betas=(t.beta1, t.beta2), eps=t.adam_eps)
        self.global_step = int(exp.state.step)
        self.rampup_len = len(exp.pipeline) * t.n_epoch // 2
        self.noise_rng = np.random.default_rng(noise_seed)
        self.bce = torch.nn.BCELoss()
        self.mse = torch.nn.MSELoss()

    def _norm(self, feats):
        return ((feats - self._mean) / self._std)[:, None]

    def train_epoch(self, epoch: int):
        from dcase2019_task4_tpu_torch.train.ramps import sigmoid_rampup

        exp, t = self.exp, self.exp.cfg.train
        ws, ss = exp.weak_slice, exp.strong_slice
        self.model.train()
        self.ema.train()
        sums = {"loss": 0.0, "weak_class_loss": 0.0, "strong_class_loss": 0.0, "consistency_strong": 0.0,
                "consistency_weak": 0.0}
        n = 0
        for batch in exp.pipeline.iter_epoch(epoch, prefetch=0):
            feats, feats_t = self.fe.features(batch, noise_std=t.noise_std, rng=self.noise_rng)
            xs, xt = self._norm(feats), self._norm(feats_t)
            target = torch.as_tensor(np.asarray(batch["target"], np.float32), device=self.device)
            with torch.no_grad():
                sp_e, wp_e = self.ema(xt)
            sp, wp = self.model(xs)
            target_weak = target.max(-2)[0]
            wl = self.bce(wp[ws], target_weak[ws])
            sl = self.bce(sp[ss], target[ss])
            rampup = float(sigmoid_rampup(float(self.global_step), self.rampup_len))
            cc = t.max_consistency_cost * rampup
            cs = cc * self.mse(sp, sp_e)
            cw = cc * self.mse(wp, wp_e)
            loss = wl + sl + cs + cw
            self.opt.zero_grad()
            loss.backward()
            self.opt.step()
            g = self.global_step + 1  # post-increment EMA (main.py:155-157)
            alpha = min(1.0 - 1.0 / (g + 1), t.ema_alpha)
            with torch.no_grad():
                for ep_, p_ in zip(self.ema.parameters(), self.model.parameters()):
                    ep_.mul_(alpha).add_(p_, alpha=1.0 - alpha)
                # BN running stats follow the teacher's own train-mode
                # forward above, like the port's teacher buffers
            self.global_step = g
            for k, v in (("loss", loss), ("weak_class_loss", wl), ("strong_class_loss", sl),
                         ("consistency_strong", cs), ("consistency_weak", cw)):
                sums[k] += float(v.detach())
            n += 1
        return {k: v / n for k, v in sums.items()}

    def _probs(self, stream):
        from dcase2019_task4_tpu_torch.data.pipeline import iter_eval_batches

        d = self.exp.cfg.dsp
        for batch in iter_eval_batches(stream, self.exp.pipeline.batch_size, d.max_samples, d.n_window,
                                       d.hop_length, d.max_frames):
            x = self._norm(self.fe.db(self.fe.linear_mel(batch["audio"]), batch["frames"]))
            with torch.no_grad():
                strong, weak = self.model(x)
            nv = batch["n_valid"]
            yield batch, strong[:nv].cpu(), weak[:nv].cpu().numpy()

    def validate(self):
        from dcase2019_task4_tpu_torch.eval.decode import decode_batch, write_events_tsv
        from dcase2019_task4_tpu_torch.eval.sed_scores import compute_strong_metrics
        from dcase2019_task4_tpu_torch.eval.tagging import TaggingF1

        exp, d = self.exp, self.exp.cfg.dsp
        self.model.eval()
        rows = []
        for batch, strong, _ in self._probs(exp.valid_synth_stream):
            rows += decode_batch(strong, batch["filenames"], exp.codec, d.sample_rate, d.hop_length,
                                 exp.cfg.model.pooling_time_ratio, threshold=0.5,
                                 median_window=exp.cfg.train.median_window)
        ev = compute_strong_metrics(write_events_tsv(rows, None), exp.valid_synth_rows, exp.log)
        event_f1 = ev.results_class_wise_average_metrics()["f_measure"]["f_measure"]
        acc = TaggingF1(len(exp.classes))
        for batch, _, weak in self._probs(exp.valid_weak_stream):
            acc.update(weak, batch["target"][: batch["n_valid"]])
        return float(event_f1), float(np.mean(acc.per_class_f1()))


# ------------------------------------------------------------------ main


def twin_config(epochs: int):
    """The flagship `Config()` at dropout 0, `epochs` epochs, no checkpoints."""
    import dataclasses

    from dcase2019_task4_tpu_torch.config import Config, TrainConfig

    cfg = Config()
    return dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=0.0),
                               train=TrainConfig(n_epoch=epochs, checkpoint_epochs=0, save_best=False))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="twin_epochs_torch.py", description=__doc__.split("\n\n")[0])
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--subpart", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--variability", type=float, default=1.0)
    ap.add_argument("--init_checkpoint", default=None,
                    help="start both twins from this trained port checkpoint (compares decoded F1 at a "
                         "quality-bearing point)")
    ap.add_argument("--loss_tol", type=float, default=0.15, help="max per-epoch relative gap in mean total loss")
    ap.add_argument("--f1_tol", type=float, default=0.10, help="max abs gap in final event/weak F1")
    ap.add_argument("--out", default=os.path.join(REPO, "TWIN_EPOCHS_torch.json"))
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(sys.argv[1:] if argv is None else argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        print("twin_epochs_torch.py trains on a card by default and torch.cuda.is_available() is False; "
              "pass --device cpu to train on the CPU", file=sys.stderr)
        return 2
    from dcase2019_task4_tpu_torch.train.experiment import Experiment
    from dcase2019_task4_tpu_torch.utils.profiling import card_line

    card = card_line(args.device)
    exp = Experiment(twin_config(args.epochs), mean_teacher=True, subpart_data=args.subpart, synthetic_audio=True,
                     synthetic_variability=args.variability, seed=args.seed, device=args.device)
    t0 = time.time()
    exp.build()
    print(f"[port] built in {time.time() - t0:.1f}s; {len(exp.pipeline)} steps/epoch on {card}")
    if args.init_checkpoint:
        meta = exp.restore(args.init_checkpoint)
        print(f"[port] restored {args.init_checkpoint} (epoch {meta['epoch']})")

    twin = TorchTwin(exp)
    pm, ps = exp.scaler.mean_std_f32
    scaler_gap = {"mean_max_abs": float(np.max(np.abs(pm - twin.scaler_mean))),
                  "std_max_abs": float(np.max(np.abs(ps - twin.scaler_std)))}
    print(f"[scaler] device-fit vs torch-fit moment gaps: {scaler_gap}")

    doc = {"epochs": args.epochs, "subpart": args.subpart, "seed": args.seed, "variability": args.variability,
           "init_checkpoint": args.init_checkpoint, "steps_per_epoch": len(exp.pipeline),
           "scaler_gap": scaler_gap, "per_epoch": [], "card": card}

    if args.init_checkpoint:
        ours0 = exp.validate(-1)
        t_ev0, t_wk0 = twin.validate()
        doc["restored_eval"] = {"ours": {"event_f1": ours0["event_macro_f1"], "weak_f1": ours0["weak_macro_f1"]},
                                "torch": {"event_f1": t_ev0, "weak_f1": t_wk0}}
        print(f"[restored] ours event {ours0['event_macro_f1']:.4f} weak {ours0['weak_macro_f1']:.4f} | "
              f"torch event {t_ev0:.4f} weak {t_wk0:.4f}")

    start_epoch = 0 if not args.init_checkpoint else int(exp.state.step) // max(len(exp.pipeline), 1)
    for e in range(start_epoch, start_epoch + args.epochs):
        tj = time.time()
        ours = {k: m.avg for k, m in exp.train_epoch(e).meters.items()}
        tj = time.time() - tj
        tt = time.time()
        theirs = twin.train_epoch(e)
        tt = time.time() - tt
        doc["per_epoch"].append({"epoch": e, "ours": ours, "torch": theirs,
                                 "wall_s": {"ours": round(tj, 1), "torch": round(tt, 1)}})
        gap = abs(ours["loss"] - theirs["loss"]) / max(ours["loss"], theirs["loss"])
        print(f"[epoch {e}] loss ours {ours['loss']:.4f} torch {theirs['loss']:.4f} (rel gap {gap:.3f}) "
              f"[{tj:.0f}s port, {tt:.0f}s twin]")

    ours_v = exp.validate(start_epoch + args.epochs - 1)
    t_ev, t_wk = twin.validate()
    doc["final_eval"] = {"ours": {"event_f1": ours_v["event_macro_f1"], "weak_f1": ours_v["weak_macro_f1"]},
                         "torch": {"event_f1": t_ev, "weak_f1": t_wk}}
    print(f"[final] ours event {ours_v['event_macro_f1']:.4f} weak {ours_v['weak_macro_f1']:.4f} | "
          f"torch event {t_ev:.4f} weak {t_wk:.4f}")

    ok = True
    for row in doc["per_epoch"]:
        a, b = row["ours"]["loss"], row["torch"]["loss"]
        if abs(a - b) / max(a, b) > args.loss_tol:
            print(f"FAIL: epoch {row['epoch']} loss gap {abs(a - b) / max(a, b):.3f} > {args.loss_tol}")
            ok = False
    for ev in [doc["final_eval"]] + ([doc["restored_eval"]] if "restored_eval" in doc else []):
        for k in ("event_f1", "weak_f1"):
            if abs(ev["ours"][k] - ev["torch"][k]) > args.f1_tol:
                print(f"FAIL: {k} gap {abs(ev['ours'][k] - ev['torch'][k]):.4f} > {args.f1_tol}")
                ok = False
    doc["ok"] = ok
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(f"wrote {args.out}; ok={ok}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
