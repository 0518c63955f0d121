"""The port's node package.  So far it holds only ``testing.make_blocks``;
the node itself comes with a later slice."""
