"""Image I/O: FITS read/write, TIFF16 and JPEG export."""
