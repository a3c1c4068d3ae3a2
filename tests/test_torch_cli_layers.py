"""``--layers N``: the serving and training CLIs on an arch's first N layers
at full width (``configs.truncate``)."""
import dataclasses

import pytest

from repro_torch.configs import ARCHS, truncate
from repro_torch.launch import serve
from repro_torch.launch import train as train_cli


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_truncate_cuts_depth_and_keeps_width(arch):
    cfg = ARCHS[arch]
    cut = truncate(cfg, 3)
    assert cut.n_layers == min(cfg.n_layers, 3)
    assert cut.n_enc_layers == min(cfg.n_enc_layers, 3)
    assert dataclasses.replace(cut, n_layers=cfg.n_layers,
                               n_enc_layers=cfg.n_enc_layers) == cfg
    assert truncate(cfg, 0) is cfg
    assert truncate(cfg, cfg.n_layers + 5) == cfg


def test_serve_cli_serves_the_first_layers():
    run = serve.main(["--smoke", "--layers", "1", "--device", "cpu", "--batch", "1",
                      "--requests", "1", "--prompt-len", "4", "--gen", "2"])
    assert run.model.cfg.n_layers == 1 and len(run.params["blocks"]) == 1
    assert len(run.done) == 1 and len(run.done[0].out) == 2


def test_train_cli_trains_the_first_layers(monkeypatch):
    built = []
    build = train_cli.build_model

    def spy(cfg, *a, **kw):
        built.append(cfg)
        return build(cfg, *a, **kw)

    monkeypatch.setattr(train_cli, "build_model", spy)
    run = train_cli.main(["--smoke", "--layers", "1", "--device", "cpu", "--steps", "1",
                          "--batch", "2", "--seq", "8"])
    assert [c.n_layers for c in built] == [1] and run["steps"] == [0]
