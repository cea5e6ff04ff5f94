from .model import ModelBundle, build_model, batch_spec  # noqa: F401
