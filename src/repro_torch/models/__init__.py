"""The port's model zoo: the dense family so far (``registry.build``)."""
