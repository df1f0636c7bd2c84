"""Each configuration's stand-in keeps to the path it stands in for: the
system its ``entry`` builds reports, plane by plane, the engines that the
configuration file states (``engines``), at the stand-in size on the CPU
and at the configuration's own size on the card."""

import pytest

from benchmark import harness

SPEC = harness.load_spec()


def config_named(name):
    return harness.config_of(SPEC, {"config": name})


def engines(config, device):
    entry = harness.module(config["entry"])
    return entry.build(config, config["jinc_config"], device).engines


@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_standin_takes_the_engines_the_file_states(at_standin, name):
    """``impl='pallas'`` on the CPU tries the engines in the order that
    ``'auto'`` tries them on a card, so a stand-in that reports the file's
    engines here runs the same engines' plain forms in the CPU tests."""
    config = config_named(name)
    config.update(at_standin(config))
    assert engines(config, "cpu") == config["engines"]


@pytest.mark.card
@pytest.mark.parametrize("name", [c["name"] for c in SPEC["configs"]])
def test_configuration_takes_the_engines_the_file_states_on_the_card(card, name):
    """At the configuration's own size and ``impl``, as a run builds it."""
    config = config_named(name)
    assert engines(config, card) == config["engines"]
