"""Every entry point of the port runs on the card unless the caller asks
for the CPU: with no device named it asks for ``cuda``, and on a machine
without a card that raises instead of running on the host."""
import sys

import pytest

torch = pytest.importorskip("torch")


def _serve_main():
    from repro_torch.launch import serve
    serve.main()


def _serve_graph_main():
    from repro_torch.launch import serve_graph
    serve_graph.main()


def _train_main():
    from repro_torch.launch import train
    train.main()


def _train_run(tmp_path):
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch import train
    train.run(reduced(get_config("recurrentgemma-2b")), steps=1, batch=1,
              seq=8, ckpt_dir=str(tmp_path))


@pytest.mark.parametrize("entry", ["serve", "serve_graph", "train",
                                   "train.run"])
def test_entry_point_defaults_to_cuda_and_raises_without_a_card(
        entry, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.setattr(sys, "argv", [entry, "--epochs", "1"]
                        if entry == "serve_graph" else [entry])
    call = {"serve": _serve_main, "serve_graph": _serve_graph_main,
            "train": _train_main,
            "train.run": lambda: _train_run(tmp_path)}[entry]
    with pytest.raises(RuntimeError, match="'cuda' requested but"):
        call()
