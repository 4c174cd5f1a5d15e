"""Distribution: sharding rules, placement on a mesh and the layout chooser."""
