"""The component topology, rule tables and meshes of the sharded path."""
