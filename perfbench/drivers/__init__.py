"""The cells' drivers, one a file named by the driver that a traffic mix
names, each with its class ``Driver`` (``perfbench.driving``,
``perfbench.registry``)."""
