"""The system under test, built for one configuration: the port's model
module, its config and its params, made on the device from the seed with
the same blocks that the reference (ref/) makes again. One file per
architecture, found by the configuration's `arch`."""
