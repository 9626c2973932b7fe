"""Face data of the port: files, transforms, rasterisation, dataset, loader."""
