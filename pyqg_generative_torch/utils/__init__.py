from . import xrlite, checkpoints, profiling, debugging


def __getattr__(name):
    # plot and native import matplotlib / compile C++ lazily
    import importlib
    if name in ("plot", "native"):
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(name)
