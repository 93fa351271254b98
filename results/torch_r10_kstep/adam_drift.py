"""How far a graphed stage-1 run drifts from the default eager run, against
how far two eager runs do, on one GPU (the numbers in adam_drift.txt).

    python3 results/torch_r10_kstep/adam_drift.py   # from the repo root

Builds chip_smoke.py's packed 200x200 synthetic set, then for the default
algorithms and for torch's deterministic algorithms: one Play-LMP step from
one init twice eagerly and once as a graph chunk of 1 (metrics and
parameters against the first), then experiment=play_lmp_for_rl for 24
steps twice eagerly and once at trainer.steps_per_call=4 (every step
logged): the largest relative difference of each metric at each step.
The eager runs keep Adam in its default mode; the graph runs it
capturable."""
import json
import os
import sys
import tempfile

os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
sys.path.insert(0, ".")
import torch  # noqa: E402

import chip_smoke as c  # noqa: E402
from tacorl_tpu_torch import train  # noqa: E402
from tacorl_tpu_torch.core.graphs import seed_generators  # noqa: E402
from tacorl_tpu_torch.data.loader import DevicePut  # noqa: E402


def rows(d):
    return {r["step"]: r for r in map(json.loads, open(f"{d}/metrics.jsonl")) if "train/total_loss" in r}


def compare(tag, a, b):
    ra, rb = rows(a), rows(b)
    for s in sorted(set(ra) & set(rb)):
        errs = {k: abs(ra[s][k] - rb[s][k]) / max(abs(ra[s][k]), 1e-6) for k in ra[s] if k.startswith("train/")}
        worst = max(errs, key=errs.get)
        print(f"[{tag}] step {s}: worst {worst} {errs[worst]:.3g} | " +
              " ".join(f"{k[6:]}={v:.2g}" for k, v in errs.items()), flush=True)


def one_step(tag, args):
    """One step eagerly twice and once as a graph chunk of 1, from one init."""
    from tacorl_tpu_torch.config import compose, get_class
    cfg = compose(c.CONFIG_DIR, "train", args)
    out = []
    for mode in ("eager", "eager", "graph"):
        mod = get_class(cfg["module"]["_target_"])(cfg["module"], device="cuda")
        st = mod.init_state(42)
        dm = train.BasicDataModule(**{k: v for k, v in cfg["datamodule"].items() if k != "_target_"})
        dm.setup()
        batch = next(iter(dm.train_loader()))
        put = DevicePut("cuda")
        if mode == "eager":
            b = put.ready(put(batch))
            seed_generators(mod, torch.device("cuda"), 42, 0)
            st, m = mod.make_train_step()(st, b, mod.step_scalars())
        else:
            b = put.ready(put([batch]))
            st, m = mod.make_scanned_train_step()(st, b, mod.step_scalars(), seed=42)
        torch.cuda.synchronize()
        out.append(({k: float(v) for k, v in m.items()}, {k: v.detach().cpu().clone() for k, v in st.net.state_dict().items()}))
    for i, name in ((1, "eager again"), (2, "graph")):
        m0, p0 = out[0]
        mi, pi = out[i]
        merr = max(abs(mi[k] - m0[k]) / max(abs(m0[k]), 1e-6) for k in m0)
        perr = max(float((pi[k].float() - p0[k].float()).abs().max()) for k in p0)
        print(f"[{tag}] one step, {name} vs eager: metrics rel {merr:.3g} ({ {k: mi[k] - m0[k] for k in m0} }), params max abs {perr:.3g}", flush=True)


card = c.phase_env()
c.phase_build()
t = tempfile.mkdtemp()
d = c._train_data(t)
base = c._train_args("play_lmp_for_rl", d, "", 24, *c.LMP_KL, "trainer.log_every_n_steps=1")
base = [a for a in base if not a.startswith("run_dir=")]
for det in (False, True):
    torch.use_deterministic_algorithms(det, warn_only=True)
    torch.backends.cudnn.deterministic = det
    tag = "det" if det else "default"
    one_step(tag, base + [f"data_dir={d}"])
    for name, extra in (("a", []), ("b", []), ("g", ["trainer.steps_per_call=4"])):
        train.main(base + [f"run_dir={t}/{tag}_{name}", *extra])
    compare(f"{tag} eager-vs-eager", f"{t}/{tag}_a", f"{t}/{tag}_b")
    compare(f"{tag} graph-vs-eager", f"{t}/{tag}_a", f"{t}/{tag}_g")
print("SCAN_B_DONE", flush=True)
