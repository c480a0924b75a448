"""Host-side data of the port (numpy): the training dataset, batch
prefetch and scene segmentation helpers."""
