"""Device mesh + sharding of the object axis across devices."""
