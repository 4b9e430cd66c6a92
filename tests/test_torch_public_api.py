"""The port's frozen public surface, held equal to the reference's:
``repro_torch.serve.__all__`` and ``repro_torch.serve.runtime.__all__``,
the error taxonomy's (code, http_status) table, and the ``PublishSpec``
contract; the cases of ``tests/test_public_api.py``, each asserting the
port's answer and the reference's are the same."""

import dataclasses

import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.serve as j_serve  # noqa: E402
import repro.serve.runtime as j_runtime_pkg  # noqa: E402
import repro_torch.serve as serve  # noqa: E402
import repro_torch.serve.runtime as runtime_pkg  # noqa: E402
from repro.serve.runtime import PublishSpec as JPublishSpec  # noqa: E402
from repro.serve.runtime import errors as j_errors  # noqa: E402
from repro.serve.runtime.publish import resolve_spec as j_resolve_spec  # noqa: E402
from repro_torch.serve.runtime import PublishSpec, errors  # noqa: E402
from repro_torch.serve.runtime.publish import resolve_spec  # noqa: E402


def _raised(fn):
    """(type, message) of what ``fn()`` raises."""
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value).__name__, str(info.value)


def _taxonomy(mod):
    return sorted(
        (cls.__name__, cls.code, cls.http_status)
        for cls in vars(mod).values()
        if isinstance(cls, type) and issubclass(cls, mod.ServingError)
    )


def test_serve_surface_equals_the_reference():
    assert sorted(serve.__all__) == sorted(j_serve.__all__)
    assert "create_app" in serve.__all__ and "serve" in serve.__all__
    for name in serve.__all__:
        assert getattr(serve, name, None) is not None, name


def test_runtime_surface_equals_the_reference():
    assert sorted(runtime_pkg.__all__) == sorted(j_runtime_pkg.__all__)
    for name in runtime_pkg.__all__:
        assert getattr(runtime_pkg, name, None) is not None, name


def test_error_codes_and_statuses_equal_the_reference():
    table = _taxonomy(errors)
    assert table == _taxonomy(j_errors)
    # codes are unique: a wire client switching on code is unambiguous
    codes = [code for _, code, _ in table]
    assert len(codes) == len(set(codes))


def test_errors_keep_their_pre_taxonomy_bases():
    """Every pre-taxonomy ``except`` clause keeps catching, in both."""
    bases = [
        ("RuntimeOverloaded", RuntimeError),
        ("DeadlineExceeded", TimeoutError),
        ("BatcherClosed", RuntimeError),
        ("ArtifactCorrupt", RuntimeError),
        ("ModelNotFound", KeyError),
    ]
    for name, base in bases:
        assert issubclass(getattr(errors, name), base), name
        assert issubclass(getattr(j_errors, name), base), name
    # ModelNotFound messages read like messages, not quoted keys
    msgs = {str(e.ModelNotFound("no such model", ref="x")) for e in (errors, j_errors)}
    assert msgs == {"no such model"}


def test_error_to_wire_is_the_wire_body():
    e = errors.RuntimeOverloaded("queue full", retry_after_s=0.25)
    want = j_errors.RuntimeOverloaded("queue full", retry_after_s=0.25).to_wire()
    assert e.to_wire() == want == {
        "code": "overloaded",
        "status": 429,
        "message": "queue full",
        "retry_after_s": 0.25,
    }


def test_publish_spec_wire_roundtrip():
    spec = PublishSpec(alias="det", replicas=2, warmup=True)
    j_spec = JPublishSpec(alias="det", replicas=2, warmup=True)
    want = {"alias": "det", "replicas": 2, "warmup": True}
    assert spec.to_wire() == j_spec.to_wire() == want
    assert PublishSpec.from_wire(j_spec.to_wire()) == spec


def test_publish_spec_exact_never_crosses_the_wire():
    want = JPublishSpec(exact=object()).to_wire()
    assert PublishSpec(exact=object()).to_wire() == want == {"has_exact": True}


def test_publish_spec_rejects_unknown_wire_fields():
    got = _raised(lambda: PublishSpec.from_wire({"replcas": 2}))
    assert got == _raised(lambda: JPublishSpec.from_wire({"replcas": 2}))
    assert got[0] == "ValueError" and "unknown PublishSpec fields" in got[1]


def test_publish_spec_validates_replicas():
    got = _raised(lambda: PublishSpec(replicas=0))
    assert got == _raised(lambda: JPublishSpec(replicas=0))
    assert got[0] == "ValueError"


def test_publish_spec_is_frozen():
    def assign(cls):
        cls().alias = "x"

    got = _raised(lambda: assign(PublishSpec))
    assert got == _raised(lambda: assign(JPublishSpec))
    assert got[0] == dataclasses.FrozenInstanceError.__name__


def test_legacy_kwargs_fold_with_deprecation_warning():
    specs = []
    for resolve in (resolve_spec, j_resolve_spec):
        with pytest.warns(DeprecationWarning, match="Runtime.publish"):
            spec = resolve(None, caller="Runtime.publish", exact=None, replicas=3)
        specs.append(spec)
    assert specs[0] == PublishSpec(replicas=3)
    assert specs[0].to_wire() == specs[1].to_wire()


def test_spec_plus_legacy_kwargs_is_an_error():
    got = _raised(lambda: resolve_spec(PublishSpec(), caller="x", replicas=2))
    want = _raised(lambda: j_resolve_spec(JPublishSpec(), caller="x", replicas=2))
    assert got == want
    assert got[0] == "TypeError" and "not both" in got[1]


@pytest.mark.parametrize("package", ["kernels.common", "sharding"])
def test_package_surface_equals_the_reference(package):
    """``repro_torch.kernels.common`` (with ``autotune``) and
    ``repro_torch.sharding`` export the reference's names."""
    import importlib

    port = importlib.import_module(f"repro_torch.{package}")
    ref = importlib.import_module(f"repro.{package}")
    assert sorted(port.__all__) == sorted(ref.__all__)
    for name in port.__all__:
        assert getattr(port, name, None) is not None, name


def test_tuning_and_autotune_have_the_reference_names():
    from repro.kernels.common import autotune as j_autotune
    from repro.kernels.common import tuning as j_tuning
    from repro_torch.kernels.common import autotune, tuning

    public = lambda mod: {n for n in vars(mod) if not n.startswith("_") and callable(getattr(mod, n))}  # noqa: E731
    names = {"platform", "shape_key", "bucket", "validate_table", "load_table", "lookup",
             "record", "clear_overrides", "save_table", "reload_table"}
    assert names <= public(tuning) and names <= public(j_tuning)
    assert tuning.TABLE_PATH.endswith("repro_torch/kernels/common/tuning_table.json")
    assert {"measure", "sweep", "prune_candidates", "autotune"} <= public(autotune) & public(j_autotune)
