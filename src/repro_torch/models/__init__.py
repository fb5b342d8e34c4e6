"""The port's model zoo: the dense and hybrid families (``registry.build``)."""
