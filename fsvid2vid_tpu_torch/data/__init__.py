"""Data of the port: files, transforms, rasterisation, the face, pose and
street datasets, the loader, pose preprocessing and the packed store."""
