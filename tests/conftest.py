def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU with the CUDA toolkit (the port's kernels); "
        "skips elsewhere")
