"""Host-side data helpers of the inference path (``npz_dataset``'s tables,
``augment``'s crop and resize), without ``cv2`` or ``yaml``."""
