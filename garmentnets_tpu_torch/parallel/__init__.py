"""Several devices: device meshes, batch padding and sharding, and the
process group of data-parallel training (torch port of
garmentnets_tpu/parallel/)."""
