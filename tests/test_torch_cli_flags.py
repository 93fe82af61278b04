"""The port's CLI surface against the JAX CLI's: the same 34 command names,
and for each command the same option strings and positional arguments,
plus --device exactly where the port's command reaches the card. Each
port command prints its --help with exit code 0."""

import argparse

import pytest

pytest.importorskip("torch")

from wgbs_tools_tpu.cli.main import COMMANDS as JAX_COMMANDS  # noqa: E402

# the port's commands that run on the card (their --device picks it), and
# the worker, whose --warm pileup runs there
DEVICE_COMMANDS = {"pat2beta", "segment", "beta_to_blocks", "beta_to_table",
                   "beta_cov", "pat2pairs", "homog", "bam2pat",
                   "split_by_allele", "find_markers", "mask_pat", "mix_pat",
                   "worker"}


class _Parsed(Exception):
    def __init__(self, parser):
        super().__init__(parser.prog)
        self.parser = parser


def _surface(runner, monkeypatch):
    """(option strings, positional names) of the parser a command builds,
    caught at its parse_args before it parses anything."""
    def catch(self, args=None, namespace=None):
        raise _Parsed(self)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", catch)
        with pytest.raises(_Parsed) as e:
            runner([])
    actions = e.value.parser._actions
    return ({o for a in actions for o in a.option_strings},
            [a.dest for a in actions if not a.option_strings])


def test_port_registry_equals_jax():
    from wgbs_tools_tpu_torch.cli.main import COMMANDS

    assert list(COMMANDS) == list(JAX_COMMANDS)
    assert len(COMMANDS) == 34
    assert DEVICE_COMMANDS <= set(COMMANDS)


@pytest.mark.parametrize("cmd", list(JAX_COMMANDS))
def test_flags_equal_jax(cmd, monkeypatch):
    from wgbs_tools_tpu_torch.cli.main import COMMANDS

    jax_opts, jax_pos = _surface(JAX_COMMANDS[cmd], monkeypatch)
    opts, pos = _surface(COMMANDS[cmd], monkeypatch)
    assert pos == jax_pos
    assert "--device" not in jax_opts
    assert opts == jax_opts | ({"--device"} if cmd in DEVICE_COMMANDS
                               else set())


@pytest.mark.parametrize("cmd", list(JAX_COMMANDS))
def test_help_exits_0(cmd, capsys):
    from wgbs_tools_tpu_torch.cli.main import main

    with pytest.raises(SystemExit) as e:
        main([cmd, "--help"])
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert out.startswith("usage: ") and (cmd in out.splitlines()[0])
