"""Copy of ``tests/test_cli.py`` against the port, case by case.

Each case keeps its JAX name. The mapping: the import root
``tf_operator_tpu_torch``; ``nvidia.com/gpu`` (``RESOURCE_GPU``) for
``google.com/tpu``; ``h100-N`` for ``v5e-N``; the NVLink domain for the
ICI domain; ``gpu_controller.GPUJobController`` for
``tpu_controller.TPUJobController``; and the torch env (``RANK``,
``MASTER_ADDR``:``MASTER_PORT``) for the TPU one (``TPU_WORKER_ID``,
``JAX_COORDINATOR_ADDRESS``).

The JAX suite's own description follows.

CLI flag parsing + Server assembly regression tests.

Round-3 regression: Server.__init__ referenced an undefined
parse_int_map, so every `python -m tf_operator_tpu_torch` invocation crashed
with a NameError. These tests construct Server directly (with and
without the gang flags) so the entrypoint can never ship broken again.
Reference bar: cmd/tf-operator.v1/main.go:52-68 + app/options/options.go:53-83.
"""

import argparse

import pytest

from tf_operator_tpu_torch.cli import Server, build_parser, parse_int_map


# --- parse_int_map -------------------------------------------------------

def test_parse_int_map_empty():
    assert parse_int_map("") == {}
    assert parse_int_map("   ") == {}


def test_parse_int_map_single():
    assert parse_int_map("prod=100") == {"prod": 100}


def test_parse_int_map_multi_with_spaces():
    assert parse_int_map("prod=100, batch=10 ,best-effort=0") == {
        "prod": 100, "batch": 10, "best-effort": 0}


def test_parse_int_map_negative_and_trailing_comma():
    assert parse_int_map("low=-5,") == {"low": -5}


def test_parse_int_map_dict_passthrough():
    src = {"prod": 1}
    out = parse_int_map(src)
    assert out == src and out is not src


def test_parse_int_map_malformed_no_equals():
    with pytest.raises(argparse.ArgumentTypeError, match="malformed"):
        parse_int_map("prod")


def test_parse_int_map_malformed_empty_name():
    with pytest.raises(argparse.ArgumentTypeError, match="malformed"):
        parse_int_map("=5")


def test_parse_int_map_non_integer_value():
    with pytest.raises(argparse.ArgumentTypeError, match="not an integer"):
        parse_int_map("prod=ten")


# --- Server assembly -----------------------------------------------------

BASE = ["--monitoring-port", "0", "--no-leader-elect"]


def test_server_constructs_without_gang_flags():
    server = Server(build_parser().parse_args(BASE))
    try:
        assert server.operator is not None
    finally:
        server.shutdown()


def test_server_constructs_with_all_gang_flags():
    args = build_parser().parse_args(BASE + [
        "--enable-gang-scheduling", "--total-chips", "16",
        "--gang-fairness", "aged", "--gang-aging-seconds", "60",
        "--gang-priority-classes", "prod=100,batch=10",
        "--gang-queue-quotas", "prod=8,batch=4",
        "--gang-preemption"])
    server = Server(args)
    try:
        gang = server.operator.controller.engine.gang
        assert gang is not None
        assert gang.priority_classes == {"prod": 100, "batch": 10}
        assert gang.queue_quotas == {"prod": 8, "batch": 4}
        assert gang.preemption is True
    finally:
        server.shutdown()


def test_slice_health_flags_parse_with_defaults():
    args = build_parser().parse_args(BASE)
    assert args.slice_health is True
    assert args.health_drain_grace_seconds == 0.0
    args = build_parser().parse_args(BASE + [
        "--no-enable-slice-health",
        "--health-drain-grace-seconds", "45"])
    assert args.slice_health is False
    assert args.health_drain_grace_seconds == 45.0


def test_main_rejects_malformed_gang_map(capsys):
    """Malformed map flags must produce an argparse usage error (exit
    code 2 with the offending flag named), never a raw traceback."""
    from tf_operator_tpu_torch.cli import main
    with pytest.raises(SystemExit) as exc:
        main(BASE + ["--gang-priority-classes", "prod=high"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--gang-priority-classes" in err
    assert "not an integer" in err


def test_enable_elastic_requires_gang_scheduling(capsys):
    from tf_operator_tpu_torch.cli import main
    with pytest.raises(SystemExit) as exc:
        main(BASE + ["--enable-elastic"])
    assert exc.value.code == 2
    assert "--enable-gang-scheduling" in capsys.readouterr().err


def test_enable_elastic_rejected_on_kube_backend(capsys):
    """--enable-elastic on --backend kube must fail fast with a pointer
    to the node-agent open item (ROADMAP item 1): a shrink's
    save-before-evict barrier needs the notice/ack relay kubelet
    cannot provide."""
    from tf_operator_tpu_torch.cli import main
    with pytest.raises(SystemExit) as exc:
        main(BASE + ["--enable-gang-scheduling", "--enable-elastic",
                     "--backend", "kube"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--enable-elastic" in err
    assert "node" in err and "agent" in err


def test_enable_elastic_wires_the_resize_pass():
    args = build_parser().parse_args(BASE + [
        "--enable-gang-scheduling", "--enable-elastic",
        "--total-chips", "16"])
    server = Server(args)
    try:
        gang = server.operator.controller.engine.gang
        assert gang is not None and gang.elastic is True
    finally:
        server.shutdown()


def test_elastic_off_by_default():
    args = build_parser().parse_args(BASE + ["--enable-gang-scheduling"])
    server = Server(args)
    try:
        assert server.operator.controller.engine.gang.elastic is False
    finally:
        server.shutdown()


def test_serving_autoscaler_requires_serving_and_elastic(capsys):
    from tf_operator_tpu_torch.cli import main
    with pytest.raises(SystemExit) as exc:
        main(BASE + ["--enable-serving-autoscaler"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--enable-serving" in err and "--enable-elastic" in err


def test_serving_autoscaler_rejected_on_kube_backend(capsys):
    """It rides the elastic resize pass, which kube does not run yet
    (docs/serving.md): fail fast rather than silently never scaling."""
    from tf_operator_tpu_torch.cli import main
    with pytest.raises(SystemExit) as exc:
        main(BASE + ["--enable-gang-scheduling", "--enable-elastic",
                     "--enable-serving", "--enable-serving-autoscaler",
                     "--backend", "kube"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "--enable-serving-autoscaler" in err and "kube" in err


def test_serving_gateway_needs_spool(capsys):
    from tf_operator_tpu_torch.cli import main
    with pytest.raises(SystemExit) as exc:
        main(BASE + ["--enable-serving-gateway"])
    assert exc.value.code == 2
    assert "--gateway-spool" in capsys.readouterr().err


def test_serving_front_door_wires_up(tmp_path):
    """Gateway + autoscaler assembly: the gateway fronts the given
    spool and the autoscaler is handed the gang scheduler AND serves as
    its resize-signal provider (the wiring docs/serving.md promises)."""
    args = build_parser().parse_args(BASE + [
        "--enable-gang-scheduling", "--enable-elastic",
        "--enable-serving", "--enable-serving-autoscaler",
        "--enable-serving-gateway", "--gateway-port", "0",
        "--gateway-spool", str(tmp_path / "spool")])
    server = Server(args)
    try:
        autoscaler = server.operator.autoscaler
        gang = server.operator.controller.engine.gang
        assert autoscaler is not None
        assert autoscaler.gang is gang
        assert gang.resize_signals == autoscaler.signals
        assert server.gateway is not None
        assert server.gateway.spool.root == str(tmp_path / "spool")
    finally:
        server.shutdown()


def test_version_wins_over_backend_validation(capsys):
    """`--version` prints and exits even when combined with flags that
    would otherwise fail validation (e.g. --backend none w/o api-port)."""
    from tf_operator_tpu_torch.cli import main
    assert main(["--backend", "none", "--version"]) == 0
    assert "tpu-operator" in capsys.readouterr().out

# CI shard (pyproject [tool.pytest.ini_options] markers)
pytestmark = pytest.mark.control_plane
